"""T5 / mT5 configs for the PyTorch port (the port's own copy of
easynlp_tpu/modelzoo/models/t5/configuration_t5.py: HF attribute names and
the same defaults)."""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig


class T5Config(PretrainedConfig):
    model_type = "t5"

    def __init__(self, vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                 num_layers=6, num_decoder_layers=None, num_heads=8,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128, dropout_rate=0.1,
                 layer_norm_epsilon=1e-6, initializer_factor=1.0,
                 feed_forward_proj="relu", decoder_start_token_id=0,
                 pad_token_id=0, eos_token_id=1, **kwargs):
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = (num_decoder_layers
                                   if num_decoder_layers is not None
                                   else num_layers)
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_factor = initializer_factor
        self.feed_forward_proj = feed_forward_proj
        self.decoder_start_token_id = decoder_start_token_id
        kwargs.setdefault("hidden_size", d_model)
        kwargs.setdefault("num_hidden_layers", num_layers)
        kwargs.setdefault("num_attention_heads", num_heads)
        kwargs.setdefault("is_encoder_decoder", True)
        kwargs.setdefault("tie_word_embeddings", True)
        super().__init__(vocab_size=vocab_size, pad_token_id=pad_token_id,
                         eos_token_id=eos_token_id, **kwargs)

    @property
    def is_gated_act(self):
        return self.feed_forward_proj.startswith("gated-")

    @property
    def dense_act_fn(self):
        return self.feed_forward_proj.replace("gated-", "")


class MT5Config(T5Config):
    model_type = "mt5"

    def __init__(self, **kwargs):
        kwargs.setdefault("feed_forward_proj", "gated-gelu_new")
        super().__init__(**kwargs)
