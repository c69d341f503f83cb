"""The model zoo: configurations, layers, the decoder-only transformer and
the xLSTM."""
