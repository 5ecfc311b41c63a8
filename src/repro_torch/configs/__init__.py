"""Model configurations of the LM stack: the schema (``base``), the ten
architectures (one module each) and the ``--arch`` registry."""
