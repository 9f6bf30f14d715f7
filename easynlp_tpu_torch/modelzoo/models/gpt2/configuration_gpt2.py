"""GPT-2 config for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/gpt2/configuration_gpt2.py, which
the port cannot import (that package's `__init__` pulls in the JAX model).
Same HF attribute names (n_embd/n_layer/n_head, ...) and the same canonical
aliases, on the port's PretrainedConfig, so a reference
config.json loads unchanged. Like the JAX config it leaves pad_token_id at
PretrainedConfig's 0, which is the ordinary token "!" in GPT-2's vocabulary
(ROADMAP C9).
"""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig


class GPT2Config(PretrainedConfig):
    model_type = "gpt2"

    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, n_inner=None,
                 activation_function="gelu_new", resid_pdrop=0.1,
                 embd_pdrop=0.1, attn_pdrop=0.1, layer_norm_epsilon=1e-5,
                 initializer_range=0.02, bos_token_id=50256,
                 eos_token_id=50256, num_experts=0, moe_top_k=1,
                 expert_capacity_factor=1.25, router_aux_loss_coef=0.01,
                 **kwargs):
        self.num_experts = num_experts
        self.moe_top_k = moe_top_k
        self.expert_capacity_factor = expert_capacity_factor
        self.router_aux_loss_coef = router_aux_loss_coef
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_inner = n_inner if n_inner is not None else 4 * n_embd
        self.activation_function = activation_function
        self.resid_pdrop = resid_pdrop
        self.embd_pdrop = embd_pdrop
        self.attn_pdrop = attn_pdrop
        self.layer_norm_epsilon = layer_norm_epsilon
        # canonical aliases used by shared machinery
        kwargs.setdefault("hidden_size", n_embd)
        kwargs.setdefault("num_hidden_layers", n_layer)
        kwargs.setdefault("num_attention_heads", n_head)
        kwargs.setdefault("intermediate_size", self.n_inner)
        kwargs.setdefault("max_position_embeddings", n_positions)
        kwargs.setdefault("layer_norm_eps", layer_norm_epsilon)
        kwargs.setdefault("is_decoder", True)
        super().__init__(vocab_size=vocab_size,
                         initializer_range=initializer_range,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id,
                         **kwargs)
