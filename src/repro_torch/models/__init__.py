"""The route-scorer models: the dense decoder family (``registry.build_model``)."""
