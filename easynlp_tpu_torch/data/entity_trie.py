"""Token-id trie for longest-match entity linking (the PyTorch port's own
copy of easynlp_tpu/data/entity_trie.py, the reference's KangarooTrieTree,
easynlp/appzoo/language_modeling/data.py:860-905)."""


class TokenTrie:
    """Maps token-id sequences; search returns all match end positions."""

    __slots__ = ("edge", "flag")

    def __init__(self):
        self.edge = [{}]
        self.flag = [False]

    def add_word(self, word):
        u = 0
        for tok in word:
            nxt = self.edge[u].get(tok)
            if nxt is None:
                self.edge.append({})
                self.flag.append(False)
                nxt = len(self.edge) - 1
                self.edge[u][tok] = nxt
            u = nxt
        self.flag[u] = True

    def search(self, sentence, start):
        """All end indices j such that sentence[start:j] is a stored word."""
        u = 0
        i = start
        out = []
        while i < len(sentence):
            u = self.edge[u].get(sentence[i])
            if u is None:
                break
            i += 1
            if self.flag[u]:
                out.append(i)
        return out
