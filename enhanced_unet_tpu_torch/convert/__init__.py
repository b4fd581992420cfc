"""Weight and training-state conversion into the PyTorch port: JAX trees
(`jax_params`), ImageNet-pretrained encoders (`pretrained`) and reference
`.pth` checkpoints (`torch_import`)."""

from enhanced_unet_tpu_torch.convert.jax_params import (
    optimizer_state_from_jax,
    resume_from_jax,
    state_dict_from_jax,
)
from enhanced_unet_tpu_torch.convert.pretrained import (
    WEIGHT_MANIFEST,
    initialize_pretrained,
    required_weights,
    verify_weight_file,
)
from enhanced_unet_tpu_torch.convert.torch_import import load_torch_checkpoint

__all__ = ["optimizer_state_from_jax", "resume_from_jax", "state_dict_from_jax",
           "WEIGHT_MANIFEST", "initialize_pretrained", "required_weights",
           "verify_weight_file", "load_torch_checkpoint"]
