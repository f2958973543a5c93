"""Models: the Llama family, KV-cache generation and continuous batching."""
