"""Checkpointing — counterpart of ``deepspeed_tpu/checkpoint``: crash-safe
save / load of the training state, the fp32 export, and Hugging Face
safetensors import / export."""
from .hf_import import config_from_hf, export_hf_checkpoint, load_hf_checkpoint  # noqa: F401
from .saving import export_fp32_state_dict, load_checkpoint, save_checkpoint  # noqa: F401
