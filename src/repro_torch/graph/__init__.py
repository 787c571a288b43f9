"""Graph substrate: CSR structure, generators, colorings."""
