"""The generic seq2seq `transformer` family's config for the PyTorch port
(the port's own copy of
easynlp_tpu/modelzoo/models/transformer/configuration_transformer.py).

ParlAI-style fields (embedding_size, ffn_size, n_layers, n_heads, variant,
embeddings_scale, learn_positional_embeddings) set onto BartConfig's switch
set: the default variant 'xlm' is post-LN, learned positions with no
offset, a LayerNorm on the embeddings, the sqrt(d) embedding scale and a
tied head; variant 'prelayernorm' moves every block's LayerNorm before its
sublayer; learn_positional_embeddings=False takes the sinusoidal table.

The BART-level fields that the ParlAI ones set (d_model, the layer and head
counts, ...) are dropped from the keyword arguments, so the config.json a
checkpoint writes (to_dict holds both) reads back; the JAX package's
TransformerConfig takes d_model twice there and raises (ROADMAP reference
fault 24).
"""

from easynlp_tpu_torch.modelzoo.models.bart.configuration_bart import (
    BartConfig,
)


# BartConfig's arguments that __init__ derives from the ParlAI fields
_DERIVED = ("d_model", "encoder_layers", "decoder_layers",
            "encoder_attention_heads", "decoder_attention_heads",
            "encoder_ffn_dim", "decoder_ffn_dim", "max_position_embeddings",
            "activation_function", "activation_dropout",
            "decoder_start_token_id")


class TransformerConfig(BartConfig):
    model_type = "transformer"
    normalize_before = False
    position_type = "learned"
    position_offset = 0
    scale_embedding = True
    use_layernorm_embedding = True
    final_layer_norm = False

    def __init__(self, vocab_size=54944, embedding_size=512, ffn_size=2048,
                 n_layers=8, n_encoder_layers=-1, n_decoder_layers=-1,
                 n_heads=16, n_positions=512, dropout=0.1,
                 attention_dropout=0.0, relu_dropout=0.0, activation="gelu",
                 variant="xlm", embeddings_scale=True,
                 learn_positional_embeddings=True, pad_token_id=0,
                 bos_token_id=1, eos_token_id=2, **kwargs):
        for key in _DERIVED:
            kwargs.pop(key, None)
        enc_layers = n_encoder_layers if n_encoder_layers > 0 else n_layers
        dec_layers = n_decoder_layers if n_decoder_layers > 0 else n_layers
        self.variant = variant
        self.embedding_size = embedding_size
        self.ffn_size = ffn_size
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_positions = n_positions
        self.embeddings_scale = embeddings_scale
        self.learn_positional_embeddings = learn_positional_embeddings
        if variant == "prelayernorm":
            self.normalize_before = True
        kwargs.setdefault("scale_embedding", embeddings_scale)
        super().__init__(
            vocab_size=vocab_size, d_model=embedding_size,
            encoder_layers=enc_layers, decoder_layers=dec_layers,
            encoder_attention_heads=n_heads, decoder_attention_heads=n_heads,
            encoder_ffn_dim=ffn_size, decoder_ffn_dim=ffn_size,
            max_position_embeddings=n_positions,
            activation_function=activation, dropout=dropout,
            attention_dropout=attention_dropout,
            activation_dropout=relu_dropout,
            decoder_start_token_id=bos_token_id, pad_token_id=pad_token_id,
            bos_token_id=bos_token_id, eos_token_id=eos_token_id, **kwargs)
        if not learn_positional_embeddings:
            self.position_type = "sinusoidal"
