"""The route-scorer models: every assigned family (``registry``)."""
