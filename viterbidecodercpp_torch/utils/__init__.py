"""Host/device utilities: test-signal generation and the native host
chain."""
