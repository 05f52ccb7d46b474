"""Tools of the port: the measurement script run on the card, the mesh
readers and the demo-mesh writer."""
