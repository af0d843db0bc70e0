"""Device ops of the port: 2-bit decode, correlation panels, CI tests."""
