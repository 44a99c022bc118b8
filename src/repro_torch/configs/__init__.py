"""Model configurations: ``base`` (dataclasses) and one file per ported arch."""
