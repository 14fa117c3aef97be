"""Host-side native code of the port: the C++ embedding-cache JSON parser
(:mod:`debiasing_multi_modal_tpu_torch.native.ebdjson`)."""
