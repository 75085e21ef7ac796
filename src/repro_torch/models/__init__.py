"""Model zoo: ten architectures over one family-dispatched substrate."""
from .config import ModelConfig, get_config, all_names, register  # noqa: F401
