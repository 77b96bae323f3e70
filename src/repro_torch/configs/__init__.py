# Architecture configs of the LLM substrate (copies of the reference's
# dense attention-only configs); see configs.base for the registry.
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    apply_overrides,
    get_config,
    list_archs,
    register,
)
