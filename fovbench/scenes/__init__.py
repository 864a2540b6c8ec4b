"""Frozen scene generators: the port's procedural scenes as plain arrays,
so that the yardstick does not move when the port's own generators do."""
