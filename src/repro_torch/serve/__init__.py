"""Serving: the continuous-batching engine (`engine.ServeEngine`)."""
