"""The plain reference: the decoder's training step in plain PyTorch (f32,
TF32 off), and the weights both sides start from.  It imports nothing of
the program (``repro_torch``), of the JAX package or of JAX."""
