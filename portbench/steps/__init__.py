"""Step kinds: what one step of the timed loop does, one module a kind,
found by the name a traffic mix's `step` gives."""
