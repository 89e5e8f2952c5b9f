"""Model layers of the port: attention, MoE, MLP, norms, RoPE, embedding."""
