"""The plain reference of the benchmark's configurations.

Plain PyTorch in float32 with TF32 off: the backbones (Inception-v1 with
TF-'SAME' pads and slim widths, ResNet-50 v1 as slim's), the GVCNN grouping
head, the loss with its L2 term, momentum SGD with its schedule, and
BatchNorm folding.  It follows the published descriptions (Feng et al.,
CVPR 2018; Szegedy et al. 2015; He et al. 2016) and imports nothing of the
program under test: it takes weights and inputs as plain tensors keyed by
parameter name, and works out again whatever the program derives from them
(folded weights, dropout masks).

A backbone is one module, `benchmark/reference/<backbone>.py`, found by the
`backbone` key of a configuration's `model` section (`gvcnn.backbone`); the
name is one of the benchmark's names and not `gvcnn`, `layers` or `train`.
Adding a configuration whose backbone the reference lacks adds that file and
edits none.  The module holds:

  NAME         the prefix of its layers' parameter names;
  BN_SCALE     whether its BatchNorms have a learned scale;
  BN_EPS       their epsilon (the grouping head's stays 1e-3);
  MIN_SIZE     the smallest square input that reaches its final endpoint;
  channels(final)
               {endpoint: output channels} of every endpoint up to `final`;
  conv_shapes(final, h, w)
               a `layers.ConvShape` for every conv up to `final`, in the
               order of its parameters: name (weight `<name>.conv.weight`
               of shape (cout, cin, kh, kw), then its BatchNorm or its
               bias), cin, cout, (kh, kw), (sh, sw), the output (h, w)
               that its own padding gives, and `bn` (default true): false
               for a conv with a bias `<name>.conv.bias` of shape (cout,)
               and no BatchNorm (TF-Slim's `normalizer_fn=None`);
               `counting.py` counts its work from these alone;
  spatial(endpoint, h, w)
               the (h, w) of the activation at `endpoint`;
  forward(net, x, final, taps)
               NCHW x -> (the features at `final`, {tap: activation}),
               built from `layers`: `net.conv_bn`, `net.conv_bias` (the
               `bn=False` convs: conv + bias, no activation, the same in
               every mode), `conv`, `max_pool` and `avg_pool`, each 'SAME'
               or 'VALID' with kernels and strides given as an int or an
               (h, w) pair.
"""
