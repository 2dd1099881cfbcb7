"""The models of the serving and training paths, as plain functions on
dictionaries of tensors: the reference's decoder-only blocks (``attn``,
``attn_local``, ``shared_attn``, ``mamba1``, ``mamba2``, dense or MoE
feed-forwards), its encoder-decoder (:mod:`.encdec`) and its VLM front end
(:mod:`.model`)."""
