"""Model configurations: ``base`` (dataclasses) and one file per arch."""
