"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set below
that limit runs slower under load; the result line prints the card's name
and power limit beside every share of these peaks."""

BF16_FLOPS = 989e12          # bfloat16 / float16 on the tensor cores
HBM_BYTES = 3.35e12          # 80 GB of HBM3
