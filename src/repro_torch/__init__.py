"""Coconut Palm on PyTorch and CUDA: the port of the ``repro`` package.

The layout mirrors ``repro``: ``kernels`` (hand-written CUDA kernels, their
wrappers and plain PyTorch versions), ``core`` (summaries, sortable keys,
indexes, the query executor and the verification engine), ``data`` and
``launch``. Device work runs on CUDA unless the caller asks for the CPU.
"""
