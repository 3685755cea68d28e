"""The benchmark's yardstick: peaks, bounds and FLOP counts."""
