"""Models: the Llama and MoE families, KV-cache and speculative generation,
and continuous batching."""
