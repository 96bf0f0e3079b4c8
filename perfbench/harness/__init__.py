"""What every cell of the benchmark shares: the manifest, the run record,
the seeded weights, the work counts and the device trace."""
