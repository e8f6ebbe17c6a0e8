"""The traffic drivers, one module per kind of serving loop: a mix's file
names its driver, and ``run(harness)`` runs one cell with it."""
