from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: F401
from repro_torch.serving.frontend import AsyncServingEngine  # noqa: F401
from repro_torch.serving.kv_pool import (BlockTable, PagePool,  # noqa: F401
                                         PoolExhausted)
from repro_torch.serving.prefix_cache import (PrefixCache,  # noqa: F401
                                              PrefixHit)
from repro_torch.serving.scheduler import (RequestView,  # noqa: F401
                                           Scheduler, SLOScheduler)
from repro_torch.serving.spec_decode import (DraftModelDrafter,  # noqa: F401
                                             Drafter, NGramDrafter,
                                             make_drafter)
