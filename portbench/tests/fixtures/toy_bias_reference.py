"""The fixture's reference: ``reference.py`` with an attention sublayer
that adds the layout's output bias ``attn.bo``."""

from portbench import reference


def attention(x, p, lin, arch, pos, n_prompt_end, cache_len):
    return reference.gqa_attention(x, p, lin, arch, pos, n_prompt_end,
                                   cache_len) + p["bo"]


def served_logits(params, arch, items, cache_len, mode="f32"):
    return reference.served_logits(params, arch, items, cache_len, mode=mode,
                                   attention=attention)
