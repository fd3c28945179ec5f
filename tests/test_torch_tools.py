"""Port parity, the dataset entry points and the sampler bench: the port's
`generate_dataset_binary`, `tools.make_synthetic_dataset`,
`tools.preprocess_mag` and `tools.preprocess_semeval` against the JAX
package's scripts on the same raw files (tests/fixtures/mag_mini) or the
same seed, each called in this process; `tools.sampler_bench` at a tiny
size.

Comparisons are exact: the raw files byte for byte, the pickles read by
each package's `Taxonomy.load` to equal arrays."""
import importlib.util
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from taxoexpan_torch import generate_dataset_binary as t_gen
from taxoexpan_torch.data.taxonomy import Taxonomy as TTaxonomy
from taxoexpan_torch.tools import make_synthetic_dataset as t_synth_cli
from taxoexpan_torch.tools import preprocess_mag as t_mag
from taxoexpan_torch.tools import preprocess_semeval as t_semeval
from taxoexpan_torch.tools import sampler_bench
from taxoexpan_tpu.data.taxonomy import Taxonomy as JTaxonomy

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "mag_mini"
RAW = ("mag_mini.terms", "mag_mini.taxo", "mag_mini.terms.embed")


def _run_script(path: Path, argv: list, monkeypatch) -> None:
    """A JAX-package script's `__main__` in this process."""
    monkeypatch.setattr(sys, "argv", [str(path), *map(str, argv)])
    runpy.run_path(str(path), run_name="__main__")


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same_taxonomy(a, b):
    assert a.name == b.name and list(a.vocab) == list(b.vocab)
    for field in ("features", "edges", "train_node_ids",
                  "validation_node_ids", "test_node_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)))


def _cross_load(port_pickle: Path, jax_pickle: Path):
    """Each package's Taxonomy.load reads both pickles to equal arrays."""
    ref = JTaxonomy.load(str(jax_pickle))
    for load in (JTaxonomy.load, TTaxonomy.load):
        for path in (port_pickle, jax_pickle):
            _assert_same_taxonomy(load(str(path)), ref)
    return ref


@pytest.fixture(scope="module")
def mag_raw(tmp_path_factory):
    """tests/fixtures/mag_mini through the port's preprocess_mag."""
    out = tmp_path_factory.mktemp("mag") / "port"
    t_mag.main(["--fos", str(FIXTURES / "FieldsOfStudy.txt"),
                "--children", str(FIXTURES / "FieldOfStudyChildren.txt"),
                "--embed", str(FIXTURES / "tokens.vec"),
                "--root-name", "computer science", "--name", "mag_mini",
                "--out", str(out)])
    return out


def test_preprocess_mag_matches_jax_script(mag_raw, tmp_path, monkeypatch):
    """The same .terms/.taxo/.embed files, byte for byte, as
    scripts/preprocess_mag.py writes from the same raw dumps (the subtree
    restriction and the missing-embedding drop applied)."""
    jax_out = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", [
        "preprocess_mag.py", "--fos", str(FIXTURES / "FieldsOfStudy.txt"),
        "--children", str(FIXTURES / "FieldOfStudyChildren.txt"),
        "--embed", str(FIXTURES / "tokens.vec"),
        "--root-name", "computer science", "--name", "mag_mini",
        "--out", str(jax_out)])
    _load_script("preprocess_mag").main()
    for name in RAW:
        assert (mag_raw / name).read_bytes() == \
            (jax_out / name).read_bytes(), name
    names = {line.split("\t")[1] for line in
             (mag_raw / "mag_mini.terms").read_text().splitlines()}
    assert "computer science" in names and "biology" not in names
    assert "zzzzunembeddable" not in names


@pytest.mark.parametrize("existing_partition", [False, True])
def test_generate_dataset_binary_matches_jax(mag_raw, tmp_path, monkeypatch,
                                             existing_partition):
    """`python -m taxoexpan_torch.generate_dataset_binary` and the JAX
    package's generate_dataset_binary.py on copies of the same raw files
    (the leaf split of seed 47, or .terms.{train,validation,test} files)
    write pickles that both packages read to equal arrays."""
    dirs = {}
    for who in ("port", "jax"):
        dirs[who] = tmp_path / who
        shutil.copytree(mag_raw, dirs[who])
    flags = ["-p"] if existing_partition else []
    if existing_partition:
        ids = [line.split("\t")[0] for line in
               (mag_raw / "mag_mini.terms").read_text().splitlines()]
        for d in dirs.values():
            for part, rows in (("train", ids[:-2]), ("validation",
                                                     ids[-2:-1]),
                               ("test", ids[-1:])):
                (d / f"mag_mini.terms.{part}").write_text(
                    "".join(f"{r}\n" for r in rows))
    t_gen.main(["-t", "mag_mini", "-d", str(dirs["port"]), *flags])
    _run_script(REPO / "generate_dataset_binary.py",
                ["-t", "mag_mini", "-d", dirs["jax"], *flags], monkeypatch)
    taxo = _cross_load(dirs["port"] / "mag_mini.pickle.bin",
                       dirs["jax"] / "mag_mini.pickle.bin")
    assert taxo.num_nodes > 3 and taxo.num_edges > 2


@pytest.mark.parametrize("v2", [False, True])
def test_make_synthetic_dataset_matches_jax(tmp_path, monkeypatch, v2):
    """The port's make_synthetic_dataset and scripts/make_synthetic_dataset.py
    with the same flags and seed (the v1 generator, and --v2)."""
    flags = ["--nodes", "150", "--dim", "8", "--max_children", "6",
             "--noise", "0.5", "--seed", "3"] + (["--v2"] if v2 else [])
    t_synth_cli.main(["--out", str(tmp_path / "port.pickle.bin"), *flags])
    _run_script(REPO / "scripts" / "make_synthetic_dataset.py",
                ["--out", tmp_path / "jax.pickle.bin", *flags], monkeypatch)
    taxo = _cross_load(tmp_path / "port.pickle.bin",
                       tmp_path / "jax.pickle.bin")
    assert taxo.num_nodes == 150


class _Lemma:
    def __init__(self, n):
        self._n = n

    def name(self):
        return self._n


class _Syn:
    """The nltk Synset surface build_taxonomy_files reads."""

    def __init__(self, name, lemma, definition="", hypo=()):
        self._name, self._lemma = name, lemma
        self._def, self._hypo = definition, list(hypo)

    def name(self):
        return self._name

    def lemmas(self):
        return [_Lemma(self._lemma)]

    def definition(self):
        return self._def

    def hyponyms(self):
        return self._hypo


def test_preprocess_semeval_stub_corpus_chain(tmp_path):
    """The WordNet path without the corpus, as tests/test_preprocess_e2e.py
    drives the JAX script: stub synsets through the port's pure build step
    (a lemma missing from the embeddings falls back to the definition;
    an unembeddable synset is dropped with its edge), the same files as
    the JAX script's, the port's raw ingest, then the SemEval submission
    converter on a case study in this vocabulary's naming."""
    dog = _Syn("dog.n.01", "dog")
    cat = _Syn("cat.n.01", "cat")
    pup = _Syn("puppy.n.01", "zzznothere", definition="a young dog")
    ghost = _Syn("ghost.n.01", "zzznothere", definition="zzznothere")
    animal = _Syn("animal.n.01", "animal", hypo=[dog, cat, ghost])
    dog._hypo = [pup]
    synsets = [animal, dog, cat, pup, ghost]
    tokens = ["animal", "dog", "cat", "a", "young"]
    vectors = np.random.default_rng(0).normal(
        size=(len(tokens), 6)).astype(np.float32)
    counts = t_semeval.build_taxonomy_files(synsets, tokens, vectors,
                                            "wn_mini", str(tmp_path / "port"))
    assert counts == (4, 3)
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        j_semeval = _load_script("preprocess_semeval")
    finally:
        sys.path.remove(str(REPO / "scripts"))
    assert j_semeval.build_taxonomy_files(
        synsets, tokens, vectors, "wn_mini", str(tmp_path / "jax")) == counts
    for suffix in ("terms", "taxo", "terms.embed"):
        name = f"wn_mini.{suffix}"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name

    taxo = TTaxonomy.from_raw_dir("wn_mini", str(tmp_path / "port"))
    assert taxo.num_nodes == 4 and "dog.n.01" in " ".join(taxo.vocab)
    case = tmp_path / "case.tsv"
    case.write_text("Test node index\tTrue parents\tPredicted parents\n"
                    "test.7@@@9\tdog.n.01@@@1\tpuppy.n.01@@@3, "
                    "cat.n.01@@@2\n")
    out = tmp_path / "submission.tsv"
    _load_script("parse_to_semeval_format").main(str(case), str(out))
    assert out.read_text().strip().split("\t") == ["7", "puppy#n#1",
                                                   "attach"]


def test_sampler_bench_reports_both_backends():
    """tools.sampler_bench at a tiny size: batches and egonets a second
    for the native fill, the Python fill and the loader under "auto"
    (native here, where g++ builds it)."""
    out = sampler_bench.main([
        "--nodes", "300", "--groups", "8", "--negative-size", "3",
        "--expand-factor", "4", "--max-parents", "3", "--batches", "3",
        "--python-batches", "2"])
    assert out["loader_backend"] == "native"
    assert out["egonets_per_batch"] == 8 * 4
    for key in ("native_fill", "python_fill", "loader"):
        assert out[key]["batches"] > 0 and out[key]["batches_per_s"] > 0
        assert out[key]["egonets_per_s"] == pytest.approx(
            32 * out[key]["batches_per_s"])
