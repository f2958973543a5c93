"""The serving front end: ``llm`` (ContinuousLLM, StaticLLM,
poisson_load) and its ``@batch`` decorator (``batching``)."""
