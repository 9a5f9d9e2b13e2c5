"""Launchers: meshes, step functions, the dry run, train / serve entry points."""
