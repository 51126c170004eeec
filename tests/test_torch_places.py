"""Place recognition of the port against the JAX package on the CPU: the
vocabulary (training, descent, BoW, text I/O) and the keyframe database,
on descriptors made by numpy from a seed.  Node ids, word ids, BoW
vectors, scores and candidate lists must be EQUAL (integer work and the
same numpy code); nothing here has a tolerance.  Mirrors
tests/test_places.py::TestVocabulary / TestKeyFrameDatabase."""

import numpy as np
import pytest
import torch

from orb_slam2_tpu.places.database import KeyFrameDatabase as JDatabase
from orb_slam2_tpu.places.vocabulary import Vocabulary as JVocabulary
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.places.database import KeyFrameDatabase
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary, _hamming_np
from orb_slam2_tpu_torch.utils import HostCopy


def random_descs(n, rng):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture(scope="module")
def vocabs():
    d = random_descs(2000, np.random.default_rng(0))
    return (Vocabulary.train(d, k=6, L=3, levels_up=1),
            JVocabulary.train(d, k=6, L=3, levels_up=1))


@pytest.fixture(scope="module")
def vocab(vocabs):
    return vocabs[0]


def host_walk(voc, d):
    """Reference tree walk of one descriptor on the host -> leaf node."""
    cur = 0
    while True:
        ch = voc.node_children[cur]
        ch = ch[ch >= 0]
        if len(ch) == 0:
            return cur
        dist = _hamming_np(d[None], voc.node_desc[ch])[0]
        cur = int(ch[np.argmin(dist)])


TREE_FIELDS = ("node_desc", "node_children", "node_weight", "node_parent",
               "is_leaf", "leaf_of_word", "word_of_node")


class TestVocabulary:
    def test_train_same_seed_same_tree(self, vocabs):
        voc, jvoc = vocabs
        assert (voc.k, voc.L, voc.levels_up, voc.n_words) == \
            (jvoc.k, jvoc.L, jvoc.levels_up, jvoc.n_words)
        assert voc.n_words > 100
        assert (voc.node_parent[1:] >= 0).all()
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(voc, f), getattr(jvoc, f),
                                          err_msg=f)

    def test_vocabulary_from_jax_copies_the_tree(self, vocabs):
        voc, jvoc = vocabs
        v2 = convert.vocabulary_from_jax(jvoc)
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(v2, f), getattr(voc, f))
        assert v2.node_desc is not jvoc.node_desc

    @pytest.mark.parametrize("n,seed", [(64, 1), (600, 11), (2048, 12)])
    def test_descent_equals_jax(self, vocabs, n, seed):
        voc, jvoc = vocabs
        rng = np.random.default_rng(seed)
        d = random_descs(n, rng)
        valid = rng.random(n) > 0.1
        node, word = voc.assign_nodes(d, valid)
        jnode, jword = jvoc.assign_nodes(d, valid)
        np.testing.assert_array_equal(node, jnode)
        np.testing.assert_array_equal(word, jword)
        assert node.dtype == np.int32 and word.dtype == np.int32
        assert (word[valid] >= 0).all() and (node[valid] >= 0).all()
        assert (word[~valid] == -1).all() and (node[~valid] == -1).all()

    def test_descent_matches_host_walk(self, vocab):
        """The batched descent must equal a host tree walk."""
        d = random_descs(32, np.random.default_rng(2))
        _, words = vocab.assign_nodes(d, np.ones(32, bool))
        for i in range(32):
            assert vocab.word_of_node[host_walk(vocab, d[i])] == words[i]

    def test_descent_takes_tensors_and_arrays(self, vocab):
        """int32-bit tensors (as the frontend leaves them on the device)
        and uint32 arrays give the same ids; the async half returns the
        device tensors and one HostCopy."""
        d = random_descs(100, np.random.default_rng(3))
        valid = np.ones(100, bool)
        want = vocab.assign_nodes(d, valid)
        t = torch.from_numpy(d.view(np.int32))
        got = vocab.assign_nodes(t, torch.from_numpy(valid))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        node_dev, leaf_dev, copy = vocab.assign_nodes_async(d, valid)
        assert isinstance(copy, HostCopy) and node_dev.dtype == torch.int32
        np.testing.assert_array_equal(node_dev.numpy(), want[0])
        fin = vocab.finalize_nodes(node_dev, leaf_dev, copy)
        np.testing.assert_array_equal(fin[1], want[1])

    def test_node_tables_upload_once(self, vocab):
        d = random_descs(8, np.random.default_rng(4))
        vocab.assign_nodes(d, np.ones(8, bool))
        tables = vocab._tables[torch.device("cpu")]
        vocab.assign_nodes(d, np.ones(8, bool))
        assert vocab._tables[torch.device("cpu")] is tables
        assert tables[0].dtype == torch.int32 and len(vocab._tables) == 1

    def test_record_level(self):
        """node_mid is the node at depth L - levels_up: with levels_up =
        L - 1 the child of the root, with levels_up = 0 the leaf."""
        d = random_descs(1500, np.random.default_rng(5))
        q = random_descs(50, np.random.default_rng(6))
        ones = np.ones(50, bool)
        top = Vocabulary.train(d, k=5, L=3, levels_up=2)
        node, _ = top.assign_nodes(q, ones)
        assert (top.node_parent[node] == 0).all()
        leafy = Vocabulary.train(d, k=5, L=3, levels_up=0)
        node, word = leafy.assign_nodes(q, ones)
        np.testing.assert_array_equal(leafy.word_of_node[node], word)
        for v in (top, leafy):
            jv = JVocabulary(v.k, v.L, v.node_desc, v.node_children,
                             v.node_weight, v.node_parent, v.levels_up)
            for a, b in zip(v.assign_nodes(q, ones),
                            jv.assign_nodes(q, ones)):
                np.testing.assert_array_equal(a, b)

    def test_ragged_tree_and_leaf_children(self):
        """Branches that stop early keep their leaf (no gather past a
        leaf's -1 children), as in the JAX descent."""
        rng = np.random.default_rng(7)
        # root -> 3 children; child 1 is an early leaf, the others have
        # 2 children each; L = 3 so one more level finds nothing
        parent = np.array([-1, 0, 0, 0, 1, 1, 3, 3], np.int32)
        children = np.full((8, 3), -1, np.int32)
        children[0] = [1, 2, 3]
        children[1, :2] = [4, 5]
        children[3, :2] = [6, 7]
        desc = random_descs(8, rng)
        weight = rng.random(8).astype(np.float32)
        args = (3, 3, desc, children, weight, parent)
        voc, jvoc = Vocabulary(*args, levels_up=1), JVocabulary(
            *args, levels_up=1)
        q = np.concatenate([desc, random_descs(40, rng)])
        ones = np.ones(len(q), bool)
        node, word = voc.assign_nodes(q, ones)
        jnode, jword = jvoc.assign_nodes(q, ones)
        np.testing.assert_array_equal(node, jnode)
        np.testing.assert_array_equal(word, jword)
        assert (word >= 0).all()
        # a query equal to the early leaf's descriptor ends on it
        assert voc.leaf_of_word[word[2]] == 2

    def test_bow_vector_and_score_equal_jax(self, vocabs):
        voc, jvoc = vocabs
        d = random_descs(128, np.random.default_rng(8))
        d2 = random_descs(128, np.random.default_rng(9))
        ones = np.ones(128, bool)
        _, w = voc.assign_nodes(d, ones)
        _, w2 = voc.assign_nodes(d2, ones)
        ids, weights = voc.bow_vector(w)
        jids, jweights = jvoc.bow_vector(w)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(weights, jweights)
        assert abs(weights.sum() - 1.0) < 1e-5
        assert (np.diff(ids) > 0).all()
        ids2, weights2 = voc.bow_vector(w2)
        assert Vocabulary.score_l1(ids, weights, ids, weights) \
            == pytest.approx(1.0, abs=1e-5)
        cross = Vocabulary.score_l1(ids, weights, ids2, weights2)
        assert cross == JVocabulary.score_l1(ids, weights, ids2, weights2)
        assert cross < 0.9
        empty = voc.bow_vector(np.full(5, -1, np.int32))
        assert len(empty[0]) == 0 and len(empty[1]) == 0

    def test_text_roundtrip(self, vocabs, tmp_path):
        """save_text / load_text reproduce the tree (ORBvoc.txt format,
        ref: TemplatedVocabulary.h:1338); a file saved by one package
        loads in the other."""
        voc, jvoc = vocabs
        p = tmp_path / "voc.txt"
        voc.save_text(str(p))
        jp = tmp_path / "jvoc.txt"
        jvoc.save_text(str(jp))
        assert p.read_text() == jp.read_text()
        v2 = Vocabulary.load_text(str(jp), levels_up=1)
        assert v2.k == voc.k and v2.L == voc.L
        assert v2.n_words == voc.n_words
        d = random_descs(64, np.random.default_rng(6))
        _, w1 = voc.assign_nodes(d, np.ones(64, bool))
        _, w2 = v2.assign_nodes(d, np.ones(64, bool))
        # word ids are renumbered consistently: the partition must match
        m1 = {}
        for a, b in zip(w1, w2):
            assert m1.setdefault(a, b) == b
        _, jw2 = JVocabulary.load_text(str(p), levels_up=1).assign_nodes(
            d, np.ones(64, bool))
        np.testing.assert_array_equal(w2, jw2)

    def test_load_text_rejects_malformed(self, tmp_path):
        p = tmp_path / "bad.txt"
        p.write_text("10 6 0 0\n0 1 1 2 3\n")   # wrong column count
        with pytest.raises(ValueError):
            Vocabulary.load_text(str(p))


class _FakeStore:
    """Minimal store protocol for database tests."""

    def __init__(self, n):
        self.kf_valid = np.ones(n, bool)
        self.covis = {i: {} for i in range(n)}

    def best_covisibles(self, kf, k):
        c = self.covis.get(kf, {})
        return sorted(c, key=c.get, reverse=True)[:k]


class TestKeyFrameDatabase:
    def test_reloc_candidates_find_twin(self, vocabs):
        voc, jvoc = vocabs
        rng = np.random.default_rng(7)
        store = _FakeStore(6)
        db, jdb = KeyFrameDatabase(voc), JDatabase(jvoc)
        base = random_descs(120, rng)
        words = []
        for i in range(6):
            d = base.copy() if i == 3 else random_descs(120, rng)
            _, w = voc.assign_nodes(d, np.ones(len(d), bool))
            words.append(w)
            db.add(i, w)
            jdb.add(i, w)
        cands = db.detect_reloc_candidates(words[3], store)
        assert 3 in cands
        assert cands == jdb.detect_reloc_candidates(words[3], store)
        assert db.score(3, 3) == pytest.approx(1.0, abs=1e-5)

    def test_loop_candidates_exclude_covisible(self, vocabs):
        voc, jvoc = vocabs
        rng = np.random.default_rng(8)
        store = _FakeStore(4)
        db, jdb = KeyFrameDatabase(voc), JDatabase(jvoc)
        base = random_descs(120, rng)
        for i in range(4):
            _, w = voc.assign_nodes(base, np.ones(len(base), bool))
            db.add(i, w)
            jdb.add(i, w)
        store.covis[3] = {2: 50}     # 2 covisible with the query
        ids, weights = db.bow[3]
        cands = db.detect_loop_candidates(
            3, 0.01, store, ids=ids, weights=weights)
        assert 2 not in cands
        assert any(c in (0, 1) for c in cands)
        assert cands == jdb.detect_loop_candidates(
            3, 0.01, store, ids=ids, weights=weights)

    def test_erase_and_clear(self, vocab):
        rng = np.random.default_rng(9)
        db = KeyFrameDatabase(vocab)
        for kf in (0, 1):
            _, w = vocab.assign_nodes(random_descs(50, rng),
                                      np.ones(50, bool))
            db.add(kf, w)
        db.erase(0)
        db.erase(0)                   # a second erase is a no-op
        assert 0 not in db.bow and 1 in db.bow
        assert all(0 not in s for s in db.inverted.values())
        db.clear()
        assert not db.bow and not db.inverted
