"""Linear layers and the decoder."""
