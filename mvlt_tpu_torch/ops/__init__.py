"""Layers, masks, the hand-written kernels and the blocks built from them."""
