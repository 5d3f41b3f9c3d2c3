"""Loading and saving: safetensors, diffusers snapshots, LoRA checkpoints, parameter layouts."""
