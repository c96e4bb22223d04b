"""Seeded input generators, one module a scene kind, found by the name a
configuration's `scene.generator` gives."""
