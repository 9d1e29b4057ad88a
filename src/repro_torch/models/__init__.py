"""Model families of the port: the dense transformer and Mamba-2
(``models.registry`` dispatches by family)."""
