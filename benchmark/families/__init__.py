"""Circuit families, one module each, found by the `family` of a configuration file."""
