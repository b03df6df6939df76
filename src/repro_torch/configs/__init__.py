"""Model and parallelism configurations (field for field as ``repro.configs``)."""
