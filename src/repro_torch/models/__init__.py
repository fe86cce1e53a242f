"""Model zoo of the port (``repro/models``): the dense decoder LM."""
from .model_zoo import build_model  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
