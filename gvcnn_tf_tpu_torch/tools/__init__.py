"""Tools of the port: the measurement script run on the card, the mesh
readers and the demo-mesh writer, export (`torch.export`), the serving load
generator, retrieval and the GVCNN-vs-MVCNN study."""
