"""Serving: continuous batching over a paged KV cache (the single-engine
core of ``distributeddataparallel_tpu/serving``).

A vLLM-style block KV pool over the TransformerLM decode twin
(``kv_cache``), the host-side continuous-batching scheduler with chunked
prefill (``scheduler``, a copy), the engine that runs one decode step over
the fixed slot batch, one prefill chunk or one speculative verify window
per scheduler step (``engine``), and the seeded Poisson open-loop load
generator with Zipf shared prefixes and multi-turn sessions (``loadgen``,
a copy).  The fast path layers a refcounted radix prefix cache (shared KV
blocks, copy-on-write) and n-gram speculative decoding on top.

``python -m distributeddataparallel_tpu_torch.serve`` is the CLI.  The
fleet (``handoff``, ``router``, ``fleet``: disaggregated prefill/decode
behind a session-affinity router) is ROADMAP item 19b.
"""

from distributeddataparallel_tpu_torch.serving.kv_cache import (  # noqa: F401
    SCRATCH_BLOCK,
    BlockAllocator,
    block_hash,
    copy_pool_block,
    gather_block_cache,
    kv_pool_bytes,
    make_pool,
    scatter_decode,
    scatter_prefill,
    scatter_spec,
    set_pool_block,
    set_pool_blocks,
)
from distributeddataparallel_tpu_torch.serving.scheduler import (  # noqa: F401
    Request,
    Scheduler,
    StepPlan,
)
from distributeddataparallel_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
)
from distributeddataparallel_tpu_torch.serving.loadgen import (  # noqa: F401
    LoadConfig,
    VirtualClock,
    make_trace,
    run_load,
)
