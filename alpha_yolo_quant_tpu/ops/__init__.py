"""Integer-exact compute primitives for the quantized runtime."""
