"""What every cell shares: the spec, the device, weights, tracing and the
yardstick arithmetic."""
