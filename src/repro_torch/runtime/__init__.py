"""The serving runtime (port of `repro/runtime/`): sessions, the server
core with its gang dispatcher, the fault-tolerance pieces, and the
sharding policy."""
from repro_torch.runtime.server import (  # noqa: F401
    ServerCore,
    ServerReport,
    SessionReport,
    StreamServer,
    StreamSession,
)
from repro_torch.runtime.sharding import (  # noqa: F401
    batch_specs,
    cache_specs,
    param_specs,
    physical_specs,
    resolve,
)
