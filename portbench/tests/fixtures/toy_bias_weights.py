"""The fixture's layout: ``weights.py``'s leaves and, in each layer, an
output bias ``attn.bo`` (d_model) that today's layout lacks, drawn as
zeros: the program's attention has no bias, so zero is what it serves."""

from portbench import weights


def leaves(arch):
    out = []
    for path, shape, scale in weights.leaves(arch):
        out.append((path, shape, scale))
        if path[-2:] == ("attn", "wo"):
            out.append((path[:-1] + ("bo",), (arch["d_model"],), 0.0))
    return out


def draw(arch, seed, device):
    return weights.draw(arch, seed, device, leaves=leaves(arch))
