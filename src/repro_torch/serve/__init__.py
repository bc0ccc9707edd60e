"""The serving tier: prefill and greedy decode against the KV cache, and
the wave schedulers."""
