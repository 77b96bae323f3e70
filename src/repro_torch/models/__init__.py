# The LLM substrate's dense attention trunks (the port of repro.models for
# the attn/local block kinds): layers, trunk, model, parameter conversion.
from repro_torch.models import convert, layers, model, transformer  # noqa: F401
