"""What every cell shares: the manifest and its files, inputs made from
the seed, the program's entry points, the device trace, the operation
counts and the comparison with the reference."""
