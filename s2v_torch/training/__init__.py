"""LoRA training of the DiT (counterpart of ``s2v_tpu.training``): the
v-prediction loss, the optimizer surface, the LoRA train step and the
latent batch pipeline."""
