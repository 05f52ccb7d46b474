"""The plain reference of the benchmark's configurations.

Plain PyTorch in float32 with TF32 off: Inception-v1 (TF-'SAME' pads, slim
widths), ResNet-50 v1 (slim), the GVCNN grouping head, the loss with its L2
term, momentum SGD with its schedule, and BatchNorm folding.  It follows the
published descriptions (Feng et al., CVPR 2018; Szegedy et al. 2015; He et
al. 2016) and imports nothing of the program under test: it takes weights
and inputs as plain tensors keyed by parameter name, and works out again
whatever the program derives from them (folded weights, dropout masks).
"""
