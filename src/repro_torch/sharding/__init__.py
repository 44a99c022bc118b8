"""Sharding policy: DTensor placements for parameters, activations, caches."""
