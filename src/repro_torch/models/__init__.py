from .convert import params_from_numpy
from .model import batch_specs, build_model, input_specs, mesh_axes_of

__all__ = ["batch_specs", "build_model", "input_specs", "mesh_axes_of",
           "params_from_numpy"]
