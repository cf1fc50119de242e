"""The benchmark of zktpu_torch: harness, configurations, traffic, metric readers and the plain reference."""
