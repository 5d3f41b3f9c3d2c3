"""Host-side helpers of the port: device selection, tokenizer, video."""
