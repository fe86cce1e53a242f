"""Model zoo of the port (``repro/models``): every architecture family."""
from .encdec import EncDecModel  # noqa: F401
from .hybrid import HybridModel  # noqa: F401
from .model_zoo import build_model, model_class  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
from .xlstm_model import XLSTMModel  # noqa: F401
from .partitioning import set_mesh, shard, use_mesh  # noqa: F401
