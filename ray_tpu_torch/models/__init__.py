"""Models of the port: the GPT decoder, its configs, sampling, weights."""
