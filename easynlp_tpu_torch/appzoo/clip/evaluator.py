"""CLIP evaluator for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/clip/evaluator.py: text-to-image and
image-to-text recall@1/5/10 over the validation set and their mean
(`mean_recall`, first), where the gold pair's rank counts every candidate
scoring at least as high as it (the JAX rule `>=`, so a tie ranks the
gold pair lower); with user_defined_parameters cosine_similarity=True it
reports the mean cosine similarity of the aligned pairs instead.
"""

import numpy as np

from easynlp_tpu_torch.core.evaluator import Evaluator


def retrieval_metrics(text_embeds, image_embeds):
    """[(metric, score), ...] of the JAX evaluator from the [N, P]
    embeddings of N aligned pairs."""
    sim = text_embeds @ image_embeds.T  # [N, N]; gold is the diagonal
    gold = np.diag(sim)[:, None]
    ranks_t2i = (sim >= gold).sum(-1)
    ranks_i2t = (sim.T >= gold).sum(-1)
    results = [("t2i_r%d" % k, float((ranks_t2i <= k).mean()))
               for k in (1, 5, 10)]
    results += [("i2t_r%d" % k, float((ranks_i2t <= k).mean()))
                for k in (1, 5, 10)]
    results.insert(0, ("mean_recall",
                       float(np.mean([r for _, r in results]))))
    return results


class CLIPEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)
        udp = getattr(self.args, "user_defined_parameters_dict", None) or {}
        self.cal_sim = str(udp.get("cosine_similarity", "")) == "True"

    def embeddings(self, app):
        """(text, image) embeddings [N, P] f32 of the validation rows."""
        text_embs, image_embs = [], []
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            out = self.forward(app, batch)
            text_embs.append(out["text_embeds"].float().cpu().numpy()[valid])
            image_embs.append(
                out["image_embeds"].float().cpu().numpy()[valid])
        return np.concatenate(text_embs), np.concatenate(image_embs)

    def evaluate(self, app):
        t, v = self.embeddings(app)
        if self.cal_sim:
            pair_sim = np.diag(t @ v.T)
            print("pair number: ", pair_sim.shape)
            print(pair_sim)
            print("averaged cosine similarity ", float(pair_sim.mean()))
            return [("cosine_similarity", float(pair_sim.mean()))]
        return retrieval_metrics(t, v)
