from .convert import params_from_numpy
from .model import build_model, input_specs

__all__ = ["build_model", "input_specs", "params_from_numpy"]
