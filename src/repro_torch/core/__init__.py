# Coconut — sortable data-series summarizations + compact/contiguous indexes,
# with device-resident verification on CUDA.
from .summarization import SummarizationConfig, breakpoints, paa, sax, sax_from_paa
from .sortable import (
    interleave, deinterleave, sort_by_keys, searchsorted_keys,
    searchsorted_keys_batch,
)
from .lower_bounds import ed2, mindist_paa_sax2, mindist_region2, topk_ed2
from .io_model import DiskModel, IOStats, coalesce_ranges, render_heatmap
from .external_sort import external_sort_order
from .plan import (
    BlockSource, DenseSource, GroupSource, QueryPlan, QueryStats, RangeSource,
    SourceOps,
)
from .execute import (
    execute, empty_topk_state, heap_to_sorted, merge_topk_state, recall_at_k,
    state_to_list,
)
from .verify_engine import DeviceView, VerifyEngine, get_engine, resolve_device
from .ctree import CTree, CTreeConfig, RawStore, SortedRun
from .run_registry import BufferChunk, RunRegistry, RunSet
from .clsm import CLSM, CLSMConfig
from .ingest import IngestPipeline
from .storage import (
    FileStore, SimulatedCrash, StorageEngine, WriteAheadLog, resolve_backend,
)
from .streaming import StreamConfig, StreamingIndex
from .adsplus import ADSConfig, ADSIndex
from .recommender import (
    RationaleEntry, Scenario, Recommendation, TierDecision, recommend,
    serving_tier,
)
from .autotune import (
    AutoTuner, AutoTunerConfig, DecisionRecord, Knobs, WorkloadKey,
    knob_grid, workload_key,
)
from .gateway import Gateway, GatewayConfig, GatewayStats, Response, Ticket

__all__ = [
    "SummarizationConfig", "breakpoints", "paa", "sax", "sax_from_paa",
    "interleave", "deinterleave", "sort_by_keys", "searchsorted_keys",
    "searchsorted_keys_batch",
    "ed2", "mindist_paa_sax2", "mindist_region2", "topk_ed2",
    "DiskModel", "IOStats", "coalesce_ranges", "render_heatmap",
    "external_sort_order",
    "BlockSource", "DenseSource", "GroupSource", "QueryPlan", "QueryStats",
    "RangeSource", "SourceOps", "execute", "state_to_list",
    "DeviceView", "VerifyEngine", "get_engine", "resolve_device",
    "CTree", "CTreeConfig", "RawStore", "SortedRun", "heap_to_sorted",
    "empty_topk_state", "merge_topk_state", "recall_at_k",
    "CLSM", "CLSMConfig", "StreamConfig", "StreamingIndex",
    "BufferChunk", "RunRegistry", "RunSet", "IngestPipeline",
    "FileStore", "SimulatedCrash", "StorageEngine", "WriteAheadLog",
    "resolve_backend", "ADSConfig", "ADSIndex",
    "Scenario", "Recommendation", "TierDecision",
    "RationaleEntry", "recommend", "serving_tier",
    "AutoTuner", "AutoTunerConfig", "DecisionRecord", "Knobs",
    "WorkloadKey", "knob_grid", "workload_key",
    "Gateway", "GatewayConfig", "GatewayStats", "Response", "Ticket",
]

# Runtime sanitizer (lock-order assertions + snapshot seals): opt-in via
# env var, so a run can keep the invariants armed while plain imports stay
# untouched. See repro_torch.analysis.sanitize.
import os as _os

if _os.environ.get("REPRO_SANITIZE") == "1":
    from ..analysis.sanitize import install as _sanitize_install

    _sanitize_install()
