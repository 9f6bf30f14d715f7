"""Loss library for the PyTorch port.

Counterpart of easynlp_tpu/utils/losses.py: the same functions, names,
reductions and f32 arithmetic, on tensors. Cross entropies take an
ignore_index and average over the valid positions.
"""

import torch
import torch.nn.functional as F


def mse_loss(logits, targets):
    return torch.mean((logits.float() - targets.float()) ** 2)


def per_sample_cross_entropy(logits, labels):
    """Unreduced CE: logits [B, V], labels [B] -> nll [B]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits, labels, ignore_index=-100, label_smoothing=0.0):
    """Mean CE over valid positions. logits [..., V], labels [...] int.
    Label smoothing as the JAX package writes it: (1 - a) * nll +
    a * (logz - mean(logits))."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = logz - gold
    if label_smoothing > 0.0:
        smooth = logz - torch.mean(logits, dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    denom = torch.clamp(valid.sum(), min=1)
    return nll.sum() / denom


def soft_cross_entropy(logits, soft_targets):
    """CE against a probability distribution."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.mean(torch.sum(-soft_targets * logp, dim=-1))


def vanilla_kd_loss(student_logits, teacher_logits, labels, temperature=1.0,
                    alpha=0.5, ignore_index=-100):
    """alpha * CE(student, labels) + (1 - alpha) * T^2 * KL(p_t || p_s), with
    temperature-scaled softmaxes."""
    t = float(temperature)
    s = student_logits.float() / t
    te = teacher_logits.float() / t
    log_ps = F.log_softmax(s, dim=-1)
    pt = F.softmax(te, dim=-1)
    kd = torch.mean(torch.sum(pt * (F.log_softmax(te, dim=-1) - log_ps),
                              dim=-1))
    ce = cross_entropy(student_logits, labels, ignore_index=ignore_index)
    return alpha * ce + (1.0 - alpha) * kd * t * t


def multi_label_sigmoid_ce(logits, targets):
    """BCE-with-logits over multi-hot targets."""
    logits = logits.float()
    targets = targets.float()
    per = torch.clamp(logits, min=0) - logits * targets \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.mean(per)


def hinge_loss(pos_scores, neg_scores, margin=0.3):
    """Pairwise hinge for two-tower match."""
    return torch.mean(torch.clamp(margin - pos_scores + neg_scores, min=0.0))


def cosine_embedding_loss(emb_a, emb_b, labels, margin=0.0):
    """labels in {1, -1}."""
    a = emb_a.float()
    b = emb_b.float()
    cos = torch.sum(a * b, -1) / (
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
    pos = 1.0 - cos
    neg = torch.clamp(cos - margin, min=0.0)
    return torch.mean(torch.where(labels > 0, pos, neg))


def circle_loss(sim_matrix, labels, margin=0.45, gamma=32.0):
    """Circle loss over an in-batch similarity matrix; labels[i,j]=1 when pair
    (i,j) is positive."""
    sim = sim_matrix.float()
    labels = labels.float()
    op, on = 1.0 + margin, -margin
    dp, dn = 1.0 - margin, margin
    ap = torch.clamp(op - sim, min=0.0)
    an = torch.clamp(sim - on, min=0.0)
    logit_p = -ap * (sim - dp) * gamma
    logit_n = an * (sim - dn) * gamma
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=sim.device)
    lp = torch.logsumexp(torch.where(labels > 0, logit_p, neg_inf), dim=-1)
    ln = torch.logsumexp(torch.where(labels > 0, neg_inf, logit_n), dim=-1)
    return torch.mean(F.softplus(lp + ln))


def clip_contrastive_loss(logits_per_text):
    """Symmetric in-batch contrastive loss. logits_per_text: [B, B]."""
    n = logits_per_text.shape[0]
    labels = torch.arange(n, device=logits_per_text.device)
    li = cross_entropy(logits_per_text, labels)
    lt = cross_entropy(logits_per_text.T, labels)
    return 0.5 * (li + lt)
