"""Host/device utilities: test-signal generation."""
