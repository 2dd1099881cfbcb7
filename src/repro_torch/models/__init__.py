"""Decoder-only language models of the serving path: the ``attn``,
``attn_local`` and ``mamba1`` blocks of the reference's ``repro.models``,
as plain functions on dictionaries of tensors."""
