"""Command-line launchers and the device meshes they serve on."""
