"""RLHF over the Llama family: reward and logprob models, the pipeline."""
