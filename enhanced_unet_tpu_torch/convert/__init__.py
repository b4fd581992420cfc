"""Weight and training-state conversion into the PyTorch port."""

from enhanced_unet_tpu_torch.convert.jax_params import (
    optimizer_state_from_jax,
    resume_from_jax,
    state_dict_from_jax,
)

__all__ = ["optimizer_state_from_jax", "resume_from_jax", "state_dict_from_jax"]
