"""Contrib: the int8 weight path of serving (:mod:`.quantization`)."""
