"""The port's models: CLIP vision tower, GPT-2 decoder, their composition."""
