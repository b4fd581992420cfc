"""Weight conversion into the PyTorch port."""

from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
