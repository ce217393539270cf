"""The LM substrate's model stack: configs' building blocks (``common``,
``attention``, ``moe``, ``rglru``, ``rwkv6``), the composable decoder and
encoder (``transformer``), the serving step factories (``steps``) and the
carrier of the reference's weights (``weights``). Plain PyTorch ops: the
reference runs no Pallas kernel here."""
