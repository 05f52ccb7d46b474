"""Data-sheet peaks of the cards the benchmark knows, by the name
`torch.cuda.get_device_name()` gives: NVIDIA's H100 SXM (80 GB HBM3),
dense rates without sparsity, at its 700 W power limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12,
                              "float32": 67e12, "bytes": 3.35e12},
}
