"""ResNet-18's forward FLOPs per image from its layer shapes (He et al. 2016,
Table 1): 2 × the multiply-adds of every convolution (the 7x7 stem, the 3x3
pairs, the 1x1 projections) and of the linear head. Batch norm, activations,
pooling and the residual sums are left out."""


def block_macs(side: int, cin: int, cout: int, stride: int) -> int:
    """Multiply-adds of one basic block whose input is side × side."""
    out = (side + 2 - 3) // stride + 1
    macs = out * out * cout * cin * 9 + out * out * cout * cout * 9
    if stride != 1 or cin != cout:
        macs += out * out * cout * cin
    return macs


def forward_flops(image_size: int, n_classes: int) -> int:
    side = (image_size + 6 - 7) // 2 + 1
    macs = side * side * 64 * 3 * 49
    side = (side + 2 - 3) // 2 + 1  # 3x3/2 max pool
    cin = 64
    for i in range(4):
        for j in range(2):
            cout, stride = 64 * 2 ** i, 2 if i > 0 and j == 0 else 1
            macs += block_macs(side, cin, cout, stride)
            side, cin = (side + 2 - 3) // stride + 1, cout
    return 2 * (macs + 512 * n_classes)
