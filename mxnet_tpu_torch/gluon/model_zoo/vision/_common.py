"""What the zoo's factories share."""


def no_pretrained(pretrained):
    """``pretrained=True`` raises, as in the JAX package: no weights are
    downloaded."""
    if pretrained:
        raise RuntimeError("pretrained weights need network access; load "
                           "weights into the net instead")
