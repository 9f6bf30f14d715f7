"""BART / Pegasus / Randeng configs for the PyTorch port (the port's own copy
of easynlp_tpu/modelzoo/models/bart/configuration_bart.py: HF names and the
same defaults). The port's model takes BART; Pegasus and Randeng load as
configs only (their SentencePiece tokenizer is not ported)."""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig


class BartConfig(PretrainedConfig):
    model_type = "bart"
    normalize_before = False        # post-LN
    position_type = "learned"       # learned positions with offset 2
    position_offset = 2
    scale_embedding = False
    use_layernorm_embedding = True
    final_layer_norm = False

    def __init__(self, vocab_size=50265, d_model=768, encoder_layers=6,
                 decoder_layers=6, encoder_attention_heads=12,
                 decoder_attention_heads=12, encoder_ffn_dim=3072,
                 decoder_ffn_dim=3072, max_position_embeddings=1024,
                 activation_function="gelu", dropout=0.1,
                 attention_dropout=0.0, activation_dropout=0.0,
                 decoder_start_token_id=2, forced_eos_token_id=2,
                 pad_token_id=1, bos_token_id=0, eos_token_id=2, **kwargs):
        self.d_model = d_model
        self.encoder_layers = encoder_layers
        self.decoder_layers = decoder_layers
        self.encoder_attention_heads = encoder_attention_heads
        self.decoder_attention_heads = decoder_attention_heads
        self.encoder_ffn_dim = encoder_ffn_dim
        self.decoder_ffn_dim = decoder_ffn_dim
        self.activation_function = activation_function
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.activation_dropout = activation_dropout
        self.decoder_start_token_id = decoder_start_token_id
        self.forced_eos_token_id = forced_eos_token_id
        kwargs.setdefault("scale_embedding", type(self).scale_embedding)
        kwargs.setdefault("hidden_size", d_model)
        kwargs.setdefault("num_hidden_layers", encoder_layers)
        kwargs.setdefault("num_attention_heads", encoder_attention_heads)
        kwargs.setdefault("is_encoder_decoder", True)
        super().__init__(vocab_size=vocab_size,
                         max_position_embeddings=max_position_embeddings,
                         pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, **kwargs)


class PegasusConfig(BartConfig):
    model_type = "pegasus"
    normalize_before = True         # pre-LN
    position_type = "sinusoidal"
    position_offset = 0
    scale_embedding = True
    use_layernorm_embedding = False
    final_layer_norm = True

    def __init__(self, **kwargs):
        kwargs.setdefault("pad_token_id", 0)
        kwargs.setdefault("eos_token_id", 1)
        kwargs.setdefault("decoder_start_token_id", 0)
        kwargs.setdefault("vocab_size", 96103)
        super().__init__(**kwargs)


class RandengConfig(PegasusConfig):
    """IDEA Fengshenbang Randeng seq2seq — Pegasus-family layout (reference
    models/randeng/)."""
    model_type = "randeng"
