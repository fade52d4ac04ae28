"""Model code of the port: `layers` (building blocks) and `transformer`
(the dense LLaMA-family LM)."""
