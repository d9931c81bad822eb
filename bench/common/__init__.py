"""The benchmark's own yardstick: traffic, statistics, peaks and rooflines,
trace reduction, seeded weights, the serving loop and the check."""
