"""Training-side applications of the port: HE gradient aggregation."""
