"""Model layers of the port: attention, multi-head latent attention, the
RG-LRU and xLSTM mixers, MoE, MLP, norms, RoPE, embedding."""
