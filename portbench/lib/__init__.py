"""What every cell of the benchmark shares: resolution, traffic, traces, the yardstick's arithmetic and comparisons."""
