"""Core of the port: schema, hashing, partitioning, exchange, CSR tables."""
