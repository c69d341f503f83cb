"""The model zoo: configurations, layers and the decoder-only transformer."""
