"""The fixture's arithmetic: ``counts.py``'s, and d_model adds a token a
layer for the attention's output bias."""

from portbench import counts


def bias_flops(arch, tokens):
    return float(arch["n_layers"] * arch["d_model"] * tokens)


def prefill_flops(arch, length):
    return counts.prefill_flops(arch, length) + bias_flops(arch, length)


def decode_token_flops(arch, position):
    return counts.decode_token_flops(arch, position) + bias_flops(arch, 1)
