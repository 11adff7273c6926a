"""Serving: continuous batching over a paged KV cache and the
disaggregated fleet (the port of ``distributeddataparallel_tpu/serving``).

A vLLM-style block KV pool over the TransformerLM decode twin
(``kv_cache``), the host-side continuous-batching scheduler with chunked
prefill (``scheduler``, a copy), the engine that runs one decode step over
the fixed slot batch, one prefill chunk or one speculative verify window
per scheduler step (``engine``), and the seeded Poisson open-loop load
generator with Zipf shared prefixes and multi-turn sessions (``loadgen``,
a copy).  The fast path layers a refcounted radix prefix cache (shared KV
blocks, copy-on-write) and n-gram speculative decoding on top.

The fleet layer disaggregates prefill from decode: ``handoff`` moves a
finished prefill's KV blocks between engines (digest-verified frames over
in-memory pipes or TCP, the reference's wire bytes), ``router`` is the
session-affinity front door (least-loaded admission, heartbeat health,
drain-and-requeue on engine death), and ``fleet`` wires P prefill + D
decode engines behind one router, in one process (deterministic) or one
process per engine.  ``python -m distributeddataparallel_tpu_torch.serve``
is the CLI (``--fleet P:D``).
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
from distributeddataparallel_tpu_torch.serving.handoff import (  # noqa: F401
    HandoffError,
    HandoffPayload,
    HandoffReceiver,
    HandoffSender,
    PipeChannel,
    SocketChannel,
    block_nbytes,
    extract_kv_blocks,
)
from distributeddataparallel_tpu_torch.serving.router import (  # noqa: F401
    Router,
    RouterError,
    root_block_hash,
)
from distributeddataparallel_tpu_torch.serving.fleet import (  # noqa: F401
    FleetConfig,
    FleetService,
    ServingFleet,
    fleet_worker,
)
