"""Contrib: post-training int8 quantization and the int8 weight path of
serving (:mod:`.quantization`)."""
