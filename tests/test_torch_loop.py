"""Loop closing of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in the port: Sim3 algebra, vocabulary, keyframe database, Sim3
solver, pose graph, and the functions of `models/loop_closing`. Tolerances,
stated per test: ids, masks and every integer field exact; BoW vectors and
scores 1e-6; Sim3 algebra, solver results and edge Jacobians 1e-4; the pose
graph and the loop correction 1e-4.

Map states are built with numpy in this file: `synthetic_map_arrays`
(keyframes on an arc over a shared cloud, perturbed for BA to undo) and
`loop_map_arrays`, a ring of 20 keyframes over one and a quarter turns whose
last four see the first four's structure again through duplicated landmarks
under a rigid drift that grew along the way, with descriptors of random 256
bits and a few flipped bits per observation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import keyframe_database as jkdb
from orb_slam2v2_1_tpu.models import loop_closing as jlc
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.ops import hamming as jhamming
from orb_slam2v2_1_tpu.ops import lie as jlie
from orb_slam2v2_1_tpu.ops import pose_graph as jpg
from orb_slam2v2_1_tpu.ops import sim3solver as js3
from orb_slam2v2_1_tpu.ops import vocab as jvocab

from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
from orb_slam2v2_1_tpu_torch.models import map_state
from orb_slam2v2_1_tpu_torch.ops import hamming, lie, pose_graph, sim3solver, vocab

torch.set_num_threads(2)

VOCAB_NPZ = jvocab.__file__.replace("ops/vocab.py", "data/vocab.npz")
K_NP = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
BF = 40.0


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):
    return jnp.asarray(a)


def se3_exp_np(xi):
    """se3_exp of (..., 6) tangents as numpy (one batched call)."""
    return lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


# ---------------------------------------------------------------------------
# map states built with numpy
# ---------------------------------------------------------------------------

def _empty_arrays(Kcap, Mcap, N):
    return dict(
        kf_pose=np.tile(np.eye(4, dtype=np.float32), (Kcap, 1, 1)), kf_valid=np.zeros(Kcap, bool),
        kf_frame_id=np.full(Kcap, -1, np.int32), kf_xy=np.zeros((Kcap, N, 2), np.float32),
        kf_level=np.zeros((Kcap, N), np.int32), kf_angle=np.zeros((Kcap, N), np.float32),
        kf_desc=np.zeros((Kcap, N, 8), np.uint32), kf_kp_valid=np.zeros((Kcap, N), bool),
        kf_ur=np.full((Kcap, N), -1.0, np.float32), kf_mp=np.full((Kcap, N), -1, np.int32),
        kf_parent=np.full(Kcap, -1, np.int32), kf_seq=np.full(Kcap, -1, np.int32),
        mp_pos=np.zeros((Mcap, 3), np.float32), mp_valid=np.zeros(Mcap, bool),
        mp_desc=np.zeros((Mcap, 8), np.uint32), mp_normal=np.zeros((Mcap, 3), np.float32),
        mp_min_dist=np.zeros(Mcap, np.float32), mp_max_dist=np.full(Mcap, np.inf, np.float32),
        mp_visible=np.ones(Mcap, np.int32), mp_found=np.ones(Mcap, np.int32),
        mp_first_kf=np.full(Mcap, -1, np.int32), mp_first_seq=np.zeros(Mcap, np.int32),
        loop_edges=np.full((32, 2), -1, np.int32), n_loop_edges=np.int32(0),
        covis=np.zeros((Kcap, Kcap), np.int32), n_kf=np.int32(0), n_mp=np.int32(0), n_seq=np.int32(0),
    )


def _covis_np(a):
    Kcap = a["kf_valid"].shape[0]
    sets = [set(a["kf_mp"][k][a["kf_kp_valid"][k] & (a["kf_mp"][k] >= 0)].tolist()) if a["kf_valid"][k] else set()
            for k in range(Kcap)]
    C = np.zeros((Kcap, Kcap), np.int32)
    for i in range(Kcap):
        for j in range(Kcap):
            if i != j:
                C[i, j] = len(sets[i] & sets[j])
    return C


def _project_np(Tcw, pts):
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    u = K_NP[0] * pc[:, 0] / z + K_NP[2]
    v = K_NP[1] * pc[:, 1] / z + K_NP[3]
    return np.stack([u, v], -1), u - BF / z, z


def synthetic_map_arrays(rng, n_kf=8, n_pts=256, Kcap=16, Mcap=512, N=128, noise=0.005):
    """Geometrically consistent map: keyframes on an arc observing a shared
    point cloud, with a small pose/point perturbation for BA to undo (the
    numpy analog of the JAX tests' `synthetic_map_state`)."""
    a = _empty_arrays(Kcap, Mcap, N)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(3, 7, n_pts)],
                   -1).astype(np.float32)
    a["mp_pos"][:n_pts] = pts
    a["mp_valid"][:n_pts] = True
    a["mp_max_dist"][:n_pts] = 100.0
    a["n_mp"] = np.int32(n_pts)
    for k in range(n_kf):
        xi = np.zeros(6, np.float32)
        xi[0], xi[4] = 0.15 * k, 0.02 * k
        pose = se3_exp_np(xi)
        sel = rng.choice(n_pts, size=N, replace=n_pts < N)
        uv, ur, _ = _project_np(pose, pts[sel])
        a["kf_pose"][k] = pose
        a["kf_valid"][k] = True
        a["kf_frame_id"][k] = k
        a["kf_xy"][k] = uv + rng.normal(0, 0.2, (N, 2))
        a["kf_ur"][k] = ur
        a["kf_kp_valid"][k] = True
        a["kf_mp"][k] = sel
        a["kf_parent"][k] = k - 1
        a["kf_seq"][k] = k
    a["n_kf"] = a["n_seq"] = np.int32(n_kf)
    a["covis"] = _covis_np(a)
    d = se3_exp_np(rng.normal(0, noise, (Kcap, 6)))
    pert = d @ a["kf_pose"]
    pert[0] = a["kf_pose"][0]
    a["kf_pose"] = pert.astype(np.float32)
    a["mp_pos"] = (a["mp_pos"] + rng.normal(0, 5 * noise, (Mcap, 3)) * a["mp_valid"][:, None]).astype(np.float32)
    return a


def _flip_bits(rng, desc, n):
    out = desc.copy()
    for row in out.reshape(-1, 8):
        for b in rng.choice(256, n, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


RING_STEP = 22.5  # degrees between keyframes
RING_KFS = 20  # 1.25 turns: keyframes 16-19 revisit 0-3
DRIFT = np.array([0.25, -0.05, 0.15, 0.0, 0.04, 0.01], np.float32)  # reached at 360 degrees


def loop_map_arrays(rng, Kcap=32, Mcap=2048, N=192):
    """The loop state described in the module docstring. Returns (arrays,
    D360), D360 the rigid drift between the two passes at keyframe 16."""
    a = _empty_arrays(Kcap, Mcap, N)
    lo, hi, dup_from = -40.0, RING_STEP * (RING_KFS - 1) + 40.0, 320.0
    u_base = np.sort(rng.uniform(lo, dup_from, int((dup_from - lo) * 3.4)))
    n_base = len(u_base)
    rad, hgt = rng.uniform(4.0, 6.0, n_base), rng.uniform(-1.4, 1.4, n_base)
    desc_base = rng.integers(0, 2**32, (n_base, 8), dtype=np.uint32)
    dup_src = np.nonzero(u_base + 360.0 < hi)[0]
    u_all = np.concatenate([u_base, u_base[dup_src] + 360.0])
    src = np.concatenate([np.arange(n_base), dup_src])
    n_pts = len(u_all)
    assert n_pts <= Mcap
    ang = np.radians(u_all)
    true_pos = np.stack([rad[src] * np.sin(ang), hgt[src], rad[src] * np.cos(ang)], -1).astype(np.float32)
    desc = desc_base[src].copy()
    desc[n_base:] = _flip_bits(rng, desc[n_base:], 5)

    def drift(u):
        return se3_exp_np(DRIFT * np.maximum(np.asarray(u, np.float32)[..., None] - 180.0, 0.0) / 180.0)

    D_pts = drift(u_all)
    a["mp_pos"][:n_pts] = np.einsum("nij,nj->ni", D_pts[:, :3, :3], true_pos) + D_pts[:, :3, 3]
    a["mp_valid"][:n_pts] = True
    a["mp_desc"][:n_pts] = desc
    a["n_mp"] = np.int32(n_pts)
    first_seen = np.full(n_pts, -1)
    for k in range(RING_KFS):
        u_k = RING_STEP * k
        th = np.radians(u_k)
        Rwc = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = 0.5 * Rwc[:, 2]
        Tcw_true = np.linalg.inv(Twc).astype(np.float32)
        cand = np.nonzero(np.abs(u_all - u_k) < 27.0)[0]
        uv, ur, z = _project_np(Tcw_true, true_pos[cand])
        inside = (z > 0) & (uv[:, 0] > 8) & (uv[:, 0] < 312) & (uv[:, 1] > 8) & (uv[:, 1] < 232)
        cand, uv, ur = cand[inside][:N], uv[inside][:N], ur[inside][:N]
        n = len(cand)
        a["kf_pose"][k] = Tcw_true @ np.linalg.inv(drift(u_k))
        a["kf_valid"][k] = True
        a["kf_frame_id"][k] = 3 * k
        a["kf_xy"][k, :n] = uv + rng.normal(0, 0.3, (n, 2))
        a["kf_ur"][k, :n] = ur
        a["kf_level"][k] = 1
        a["kf_desc"][k, :n] = _flip_bits(rng, desc[cand], 3)
        a["kf_kp_valid"][k, :n] = True
        a["kf_mp"][k, :n] = cand
        a["kf_parent"][k] = k - 1
        a["kf_seq"][k] = k
        new = cand[first_seen[cand] < 0]
        first_seen[new] = k
        center = -a["kf_pose"][k][:3, :3].T @ a["kf_pose"][k][:3, 3]
        vec = a["mp_pos"][new] - center
        d = np.linalg.norm(vec, axis=1)
        a["mp_normal"][new] = vec / d[:, None]
        a["mp_max_dist"][new] = 1.1 * d
        a["mp_min_dist"][new] = 0.3 * d
    seen = first_seen >= 0
    a["mp_valid"][:n_pts] = seen
    a["mp_first_kf"][:n_pts] = first_seen
    a["mp_first_seq"][:n_pts] = np.maximum(first_seen, 0)
    a["n_kf"] = a["n_seq"] = np.int32(RING_KFS)
    a["covis"] = _covis_np(a)
    return a, drift(360.0)


def jstate_of(arrays):
    return JMapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def tstate_of(arrays):
    return map_state.from_numpy(arrays, device="cpu")


def jarrays_of(jstate):
    return {name: np.asarray(v) for name, v in zip(JMapState._fields, jstate)}


def assert_states_close(tstate, jstate, atol, float_fields=("kf_pose", "mp_pos"), rot_atol=None):
    """Every integer and bool field exact, the named float fields within
    atol; with `rot_atol`, the rotation blocks of kf_pose within that."""
    got = map_state.to_numpy(tstate)
    for name, ref in zip(JMapState._fields, jstate):
        ref = np.asarray(ref)
        if name == "kf_pose" and name in float_fields and rot_atol is not None:
            np.testing.assert_allclose(got[name][:, :3, 3], ref[:, :3, 3], atol=atol, err_msg=name)
            np.testing.assert_allclose(got[name][:, :3, :3], ref[:, :3, :3], atol=rot_atol, err_msg=name)
        elif name in float_fields:
            np.testing.assert_allclose(got[name], ref, atol=atol, err_msg=name)
        elif ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got[name], ref, err_msg=name)


# `lie.project_so3`, which ends `correct_loop` and every BA, takes the four
# quaternion magnitudes from square roots of 1 +- the diagonal: where a
# rotation is about one axis, as on a ring, three of the arguments are near 0
# and a difference of 1e-6 in the input comes out as 1e-3 in the rotation (in
# both packages alike, see test_project_so3_conditioning). Rotation blocks
# after it are therefore held to this, translations and points to 1e-4.
ROT_ATOL = 5e-3


@pytest.fixture(scope="module")
def vocs():
    npz = np.load(VOCAB_NPZ)
    return jvocab.load_vocabulary(npz), vocab.load_vocabulary(npz, device="cpu")


@pytest.fixture(scope="module")
def loop_arrays():
    return loop_map_arrays(np.random.default_rng(5))


@pytest.fixture(scope="module")
def loop_states(loop_arrays):
    arrays, _ = loop_arrays
    return jstate_of(arrays), tstate_of(arrays)


# ---------------------------------------------------------------------------
# ops/lie.py, Sim3 part
# ---------------------------------------------------------------------------

def _xis(rng):
    xi = rng.normal(0, 0.4, (8, 7)).astype(np.float32)
    xi[0] = 0  # the identity
    xi[1, 3:6] = 0  # no rotation
    xi[2, 6] = 0  # no scale
    xi[3, 3:6] *= 1e-7  # under the small-angle guard
    xi[4, 6] = 1e-7
    return xi


def test_sim3_algebra_parity(rng):
    """sim3_exp / sim3_log / sim3_inverse / sim3_parts / make_sim3 within 1e-5
    of the reference (well inside the stated 1e-4), log(exp) = id to 1e-5."""
    xi = _xis(rng)
    S, Sj = lie.sim3_exp(T(xi)), jlie.sim3_exp(J(xi))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=1e-5)
    np.testing.assert_allclose(lie.sim3_log(S).numpy(), np.asarray(jlie.sim3_log(Sj)), atol=1e-5)
    np.testing.assert_allclose(lie.sim3_log(S).numpy(), xi, atol=1e-5)
    np.testing.assert_allclose(lie.sim3_inverse(S).numpy(), np.asarray(jlie.sim3_inverse(Sj)), atol=1e-5)
    for got, ref in zip(lie.sim3_parts(S), jlie.sim3_parts(Sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    R, t, s = lie.sim3_parts(S)
    np.testing.assert_allclose(lie.make_sim3(R, t, s).numpy(), S.numpy(), atol=1e-6)
    np.testing.assert_allclose(lie._sim3_W(T(xi[:, 3:6]).norm(dim=-1), T(xi[:, 6]), lie.hat(T(xi[:, 3:6]))).numpy(),
                               np.asarray(jlie._sim3_W(jnp.linalg.norm(J(xi[:, 3:6]), axis=-1), J(xi[:, 6]),
                                                       jlie.hat(J(xi[:, 3:6])))), atol=1e-5)


def test_forward_derivatives_finite_at_identity():
    """so3_log, sim3_log and sim3_exp have finite forward derivatives at the
    identity (every essential-graph edge but the loop edge starts there) and
    they equal the reference's to 1e-5."""
    J_so3 = torch.func.jacfwd(lie.so3_log)(torch.eye(3))
    assert torch.isfinite(J_so3).all()
    np.testing.assert_allclose(J_so3.numpy(), np.asarray(jax.jacfwd(jlie.so3_log)(jnp.eye(3))), atol=1e-5)
    J_log = torch.func.jacfwd(lie.sim3_log)(torch.eye(4))
    assert torch.isfinite(J_log).all()
    np.testing.assert_allclose(J_log.numpy(), np.asarray(jax.jacfwd(jlie.sim3_log)(jnp.eye(4))), atol=1e-5)
    J_exp = torch.func.jacfwd(lie.sim3_exp)(torch.zeros(7))
    np.testing.assert_allclose(J_exp.numpy(), np.asarray(jax.jacfwd(jlie.sim3_exp)(jnp.zeros(7))), atol=1e-5)


def test_project_so3_conditioning(rng):
    """A fault of the reference that the port keeps for parity: on a rotation
    about one axis, `project_so3` turns an input difference of 3e-6 into an
    output difference above 3e-4 (the square root of a near-zero pivot). On
    the same input both packages give the same output to 1e-6."""
    th = np.radians(337.5)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    Rn = R + rng.normal(0, 3e-6, (3, 3)).astype(np.float32)
    got, got_n = lie.project_so3(T(R)).numpy(), lie.project_so3(T(Rn)).numpy()
    np.testing.assert_allclose(got_n, np.asarray(jlie.project_so3(J(Rn))), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jlie.project_so3(J(R))), atol=1e-6)
    assert 3e-4 < np.abs(got_n - got).max() < ROT_ATOL


# ---------------------------------------------------------------------------
# ops/vocab.py
# ---------------------------------------------------------------------------

def _descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _assign_both(jvoc, tvoc, desc):
    pm1 = jhamming.unpack_pm1(J(desc))
    words = T(hamming.words_from_uint32(desc))
    return ((np.asarray(jvocab.assign_words(jvoc, pm1)), np.asarray(jvocab.assign_nodes(jvoc, pm1)),
             np.asarray(jvocab.assign_nodes(jvoc, pm1, depth=3))),
            (vocab.assign_words(tvoc, words).numpy(), vocab.assign_nodes(tvoc, words).numpy(),
             vocab.assign_nodes(tvoc, words, depth=3).numpy()))


def test_assign_words_and_nodes_exact(rng, vocs):
    """Word ids and node ids (depth 2 and 3) of 600 random descriptors and
    of the vocabulary's own centroids (ties between equal children): exact."""
    jvoc, tvoc = vocs
    centroids = np.packbits(np.load(VOCAB_NPZ)["level3"][::37], axis=1, bitorder="little").view(np.uint32)
    desc = np.concatenate([_descs(rng, 600), centroids])
    ref, got = _assign_both(jvoc, tvoc, desc)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert len(np.unique(got[0])) > 300
    # A leading batch dimension replaces the reference's vmap.
    words = T(hamming.words_from_uint32(desc[:600])).reshape(3, 200, 8)
    np.testing.assert_array_equal(vocab.assign_words(tvoc, words).numpy().reshape(-1), ref[0][:600])


def test_assign_words_with_holes_exact(rng, vocs):
    """`node_valid` masks holes of an incomplete tree: ids exact, and no
    descriptor lands in a hole."""
    jvoc, tvoc = vocs
    valid = [rng.uniform(size=10 ** (l + 1)) > 0.3 for l in range(4)]
    for l in range(4):  # every node keeps at least one child
        valid[l].reshape(-1, 10)[:, 0] = True
    jv = jvoc._replace(node_valid=tuple(J(v) for v in valid))
    arrays = vocab.vocabulary_to_numpy(tvoc)
    tv = vocab.vocabulary_from_numpy(arrays["nodes_pm1"], arrays["word_weight"], valid, device="cpu")
    ref, got = _assign_both(jv, tv, _descs(rng, 400))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert valid[3][got[0]].all()


def test_vocabulary_numpy_round_trip(vocs):
    """`vocabulary_to_numpy` gives the reference's +-1 centroids and weights
    exactly, and `vocabulary_from_numpy` of them gives the same words."""
    jvoc, tvoc = vocs
    arrays = vocab.vocabulary_to_numpy(tvoc)
    for got, ref in zip(arrays["nodes_pm1"], jvoc.nodes_pm1):
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32))
    np.testing.assert_array_equal(arrays["word_weight"], np.asarray(jvoc.word_weight))
    back = vocab.vocabulary_from_numpy(arrays["nodes_pm1"], arrays["word_weight"], device="cpu")
    for a, b in zip(back.nodes, tvoc.nodes):
        assert torch.equal(a, b)
    assert back.n_words == tvoc.n_words == jvoc.n_words == 10000


def test_bow_vector_and_scores_parity(rng, vocs):
    """BoW vectors and L1 scores within 1e-6."""
    jvoc, tvoc = vocs
    words = rng.integers(0, 10000, (6, 300))
    words[:, ::3] = words[:, :1]  # repeated words
    valid = rng.uniform(size=(6, 300)) > 0.2
    ref = np.stack([np.asarray(jvocab.bow_vector(J(w.astype(np.int32)), J(v), jvoc.word_weight, 10000))
                    for w, v in zip(words, valid)])
    got = vocab.bow_vector(T(words), T(valid), tvoc.word_weight, 10000)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    s_ref = np.asarray(jvocab.bow_scores(J(ref[0]), J(ref)))
    np.testing.assert_allclose(vocab.bow_scores(got[0], got).numpy(), s_ref, atol=1e-6)
    np.testing.assert_allclose(vocab.bow_scores(got[:2], got).numpy()[1],
                               np.asarray(jvocab.bow_scores(J(ref[1]), J(ref))), atol=1e-6)


def test_vocabulary_host_part_parity(rng, tmp_path):
    """`train_vocabulary`, `export_dbow2_text` and `import_dbow2_text` are
    numpy copies: trained arrays exact for equal generators, exported files
    byte-equal, imported trees (truncated to 3 levels, so with holes and
    summed weights) equal in centroids, validity and weights."""
    desc = _descs(rng, 1500)
    ref = jvocab.train_vocabulary(desc, np.random.default_rng(3))
    got = vocab.train_vocabulary(desc, np.random.default_rng(3))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    jvocab.export_dbow2_text(ref, tmp_path / "j.txt")
    vocab.export_dbow2_text(got, tmp_path / "t.txt")
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    jv = jvocab.import_dbow2_text(tmp_path / "j.txt", levels=3)
    tv = vocab.import_dbow2_text(tmp_path / "t.txt", levels=3, device="cpu")
    arrays = vocab.vocabulary_to_numpy(tv)
    for l in range(3):
        np.testing.assert_array_equal(arrays["nodes_pm1"][l], np.asarray(jv.nodes_pm1[l], np.float32))
        np.testing.assert_array_equal(arrays["node_valid"][l], np.asarray(jv.node_valid[l]))
    np.testing.assert_allclose(arrays["word_weight"], np.asarray(jv.word_weight), rtol=1e-6)


# ---------------------------------------------------------------------------
# models/keyframe_database.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def databases(vocs, loop_states):
    """Both databases after registering keyframes 0-15 one by one."""
    jvoc, tvoc = vocs
    jstate, tstate = loop_states
    jdb = jkdb.empty_database(32, 192, 10000)
    tdb = kdb.empty_database(32, 192, 10000, device="cpu")
    for k in range(16):
        if k % 2:
            jdb = jkdb.add_keyframe_from_state(jdb, jvoc, jstate, jnp.int32(k))
            tdb = kdb.add_keyframe_from_state(tdb, tvoc, tstate, k)
        else:
            jdb = jkdb.add_keyframe(jdb, jvoc, jnp.int32(k), jstate.kf_desc[k], jstate.kf_kp_valid[k])
            tdb = kdb.add_keyframe(tdb, tvoc, k, tstate.kf_desc[k], tstate.kf_kp_valid[k])
    return jdb, tdb


def assert_db_close(tdb, jdb):
    got = kdb.database_to_numpy(tdb)
    np.testing.assert_array_equal(got["words"], np.asarray(jdb.words))
    np.testing.assert_array_equal(got["valid"], np.asarray(jdb.valid))
    np.testing.assert_allclose(got["vectors"], np.asarray(jdb.vectors), atol=1e-6)


def test_add_keyframe_parity(databases):
    """Registration: words exact, valid equal, vectors 1e-6; the database is
    updated out of place; the numpy round trip keeps every field."""
    jdb, tdb = databases
    assert_db_close(tdb, jdb)
    assert int(tdb.valid.sum()) == 16
    back = kdb.database_from_numpy({k: np.asarray(v) for k, v in zip(jdb._fields, jdb)}, device="cpu")
    assert_db_close(back, jdb)


@pytest.mark.parametrize("query", [16, 17, 5])
def test_detect_loop_candidates_parity(databases, vocs, loop_states, query):
    """add_and_detect on a revisiting keyframe (16, 17) and an ordinary one
    (5): candidate masks exact, scores and min_score 1e-6; the revisits find
    the keyframe they duplicate."""
    jvoc, tvoc = vocs
    jstate, tstate = loop_states
    jdb, tdb = databases
    jdb2, js, jc = jkdb.add_and_detect(jdb, jvoc, jstate, jnp.int32(query))
    tdb2, ts, tc = kdb.add_and_detect(tdb, tvoc, tstate, query)
    assert_db_close(tdb2, jdb2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    _, _, jmin = jkdb.detect_loop_candidates(jdb2, jstate, jnp.int32(query))
    _, _, tmin = kdb.detect_loop_candidates(tdb2, tstate, query)
    np.testing.assert_allclose(float(tmin), float(jmin), atol=1e-6)
    if query >= 16:
        assert bool(tc[query - 16])
    assert not bool(tdb.valid[query]) or query == 5  # the input database was not written


def test_add_and_detect_batch_parity(databases, vocs, loop_states):
    """The batched form with -1 pads: database, scores 1e-6, masks exact."""
    jvoc, tvoc = vocs
    jstate, tstate = loop_states
    jdb, tdb = databases
    slots = np.array([16, 17, 18, 19, -1, -1, -1, -1], np.int32)
    jdb2, js, jc = jkdb.add_and_detect_batch(jdb, jvoc, jstate, J(slots))
    tdb2, ts, tc = kdb.add_and_detect_batch(tdb, tvoc, tstate, T(slots.astype(np.int64)))
    assert_db_close(tdb2, jdb2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy()[:4], np.asarray(js)[:4], atol=1e-6)
    assert tc[:4].any(dim=1).all() and not tc[4:].any()


def test_detect_reloc_candidates_parity(rng, databases, vocs, loop_states):
    jvoc, tvoc = vocs
    jstate, tstate = loop_states
    jdb, tdb = databases
    words = np.asarray(jdb.words[3]).copy()
    words[::4] = rng.integers(0, 10000, len(words[::4]))
    valid = np.asarray(jstate.kf_kp_valid[3])
    js, jc = jkdb.detect_reloc_candidates(jdb, jstate, J(words), J(valid), jvoc.word_weight)
    ts, tc = kdb.detect_reloc_candidates(tdb, tstate, T(words), T(valid), tvoc.word_weight)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert bool(tc[3])


# ---------------------------------------------------------------------------
# ops/sim3solver.py
# ---------------------------------------------------------------------------

def _sim3_problem(rng, n=160, outliers=30, fix_scale=True):
    """Matched points of two cameras related by a known Sim3, pixel noise 0.5,
    and gross outliers (chi2 far above the gate, so masks do not depend on
    rounding)."""
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 7, n)], -1).astype(np.float32)
    xi = np.array([0.3, -0.1, 0.2, 0.02, 0.15, -0.03, 0.0 if fix_scale else 0.08], np.float32)
    S12 = np.asarray(jlie.sim3_exp(J(xi)))
    p1 = (p2 @ S12[:3, :3].T + S12[:3, 3]).astype(np.float32)
    uv1 = _project_np(np.eye(4, dtype=np.float32), p1)[0] + rng.normal(0, 0.5, (n, 2))
    uv2 = _project_np(np.eye(4, dtype=np.float32), p2)[0] + rng.normal(0, 0.5, (n, 2))
    p1[:outliers] += rng.normal(0, 1.0, (outliers, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    sig = (1.2 ** (2 * rng.integers(0, 4, (2, n)))).astype(np.float32)
    return p1, p2, uv1.astype(np.float32), uv2.astype(np.float32), sig[0], sig[1], valid, S12


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_sim3_parity(rng, fix_scale):
    """Closed-form Sim3 of 3-point and 40-point sets within 1e-4; a batch of
    sets equals the single calls."""
    p1, p2, *_, S12 = _sim3_problem(rng, outliers=0, fix_scale=fix_scale)
    for sel in (slice(0, 3), slice(10, 50)):
        ref = np.asarray(js3.horn_sim3(J(p1[sel]), J(p2[sel]), fix_scale))
        got = sim3solver.horn_sim3(T(p1[sel]), T(p2[sel]), fix_scale).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, S12, atol=1e-3)
    sets = rng.integers(0, 160, (5, 3))
    batch = sim3solver.horn_sim3(T(p1)[sets], T(p2)[sets], fix_scale)
    np.testing.assert_allclose(batch[2].numpy(), sim3solver.horn_sim3(T(p1[sets[2]]), T(p2[sets[2]]), fix_scale).numpy(),
                               atol=1e-5)


def _reference_sets(key, valid):
    g = jax.random.gumbel(key, (js3.N_HYP, valid.shape[0]))
    g = jnp.where(J(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, 3)[1])


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_parity_with_injected_sets(rng, fix_scale):
    """RANSAC with the reference's hypothesis sets injected: the winning
    S12 within 1e-4, identical inlier mask and count, success."""
    p1, p2, uv1, uv2, s1, s2, valid, S12 = _sim3_problem(rng, fix_scale=fix_scale)
    key = jax.random.key(7)
    ref = js3.sim3_ransac(J(p1), J(p2), J(uv1), J(uv2), J(s1), J(s2), J(valid), J(K_NP), key, fix_scale=fix_scale)
    sets = _reference_sets(key, valid)
    got = sim3solver.sim3_ransac(T(p1), T(p2), T(uv1), T(uv2), T(s1), T(s2), T(valid), T(K_NP),
                                 sets=T(sets), fix_scale=fix_scale)
    assert bool(got.success) and bool(ref.success)
    np.testing.assert_allclose(got.S12.numpy(), np.asarray(ref.S12), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) >= 100


def test_sim3_ransac_generator_repeatable(rng):
    """With a generator: valid sets only, the same result for the same seed,
    and the known Sim3 recovered."""
    p1, p2, uv1, uv2, s1, s2, valid, S12 = _sim3_problem(rng)
    args = [T(x) for x in (p1, p2, uv1, uv2, s1, s2, valid, K_NP)]
    gen = torch.Generator().manual_seed(11)
    sets = sim3solver.hypothesis_sets(T(valid), gen)
    assert sets.shape == (sim3solver.N_HYP, 3) and T(valid)[sets].all()
    assert (sets.sort(dim=1)[0].diff(dim=1) > 0).all()
    a = sim3solver.sim3_ransac(*args, generator=torch.Generator().manual_seed(11))
    b = sim3solver.sim3_ransac(*args, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a.S12, b.S12) and bool(a.success)
    np.testing.assert_allclose(a.S12.numpy(), S12, atol=2e-2)
    with pytest.raises(ValueError):
        sim3solver.sim3_ransac(*args)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_parity(rng, fix_scale):
    """LM refinement from a perturbed start: S12 within 1e-4, identical
    inlier masks."""
    p1, p2, uv1, uv2, s1, s2, valid, S12 = _sim3_problem(rng, fix_scale=fix_scale)
    S0 = (np.asarray(jlie.sim3_exp(J(np.array([0.05, -0.03, 0.04, 0.01, -0.02, 0.01, 0.0], np.float32)))) @ S12)
    S0 = S0.astype(np.float32)
    ref = js3.optimize_sim3(J(p1), J(p2), J(uv1), J(uv2), J(1 / s1), J(1 / s2), J(valid), J(S0), J(K_NP),
                            fix_scale=fix_scale)
    got = sim3solver.optimize_sim3(T(p1), T(p2), T(uv1), T(uv2), T(1 / s1), T(1 / s2), T(valid), T(S0), T(K_NP),
                                   fix_scale=fix_scale)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2]) >= 100
    np.testing.assert_allclose(got[0].numpy(), S12, atol=2e-2)


# ---------------------------------------------------------------------------
# ops/pose_graph.py
# ---------------------------------------------------------------------------

def _graph(rng, Kn=16, extra=12):
    """A chain of Kn Sim3 poses with drift, extra covisibility edges, one
    loop edge carrying the true relative pose, and padding edges."""
    true = [np.eye(4, dtype=np.float32)]
    for _ in range(Kn - 1):
        step = np.asarray(jlie.sim3_exp(J(np.concatenate([rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3), [0.0]])
                                          .astype(np.float32))))
        true.append(step @ true[-1])
    true = np.stack(true).astype(np.float32)
    drift = np.stack([np.asarray(jlie.sim3_exp(J((np.array([0.02, 0.01, -0.015, 0.003, -0.002, 0.004, 0.002]) * k)
                                                 .astype(np.float32)))) for k in range(Kn)])
    poses = (drift @ true).astype(np.float32)
    ei = list(range(Kn - 1)) + list(rng.integers(0, Kn - 3, extra))
    ej = list(range(1, Kn)) + [i + 2 for i in ei[Kn - 1:]]
    S_ji = [poses[j] @ np.linalg.inv(poses[i]) for i, j in zip(ei, ej)]
    ei, ej = ei + [0, 0, 0], ej + [Kn - 1, 1, 2]
    S_ji += [true[Kn - 1] @ np.linalg.inv(true[0]), np.eye(4), np.eye(4)]
    valid = np.array([True] * (len(ei) - 2) + [False, False])
    weight = rng.uniform(0.5, 2.0, len(ei)).astype(np.float32)
    return poses, true, (np.array(ei, np.int32), np.array(ej, np.int32), np.stack(S_ji).astype(np.float32), weight, valid)


def test_edge_residual_and_jacobians_parity(rng):
    """Residuals and both 7x7 Jacobians of every edge within 1e-4, finite
    where the residual is exactly zero."""
    poses, _, (ei, ej, S_ji, _, _) = _graph(rng)
    jac = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=(0, 1)), in_axes=(None, None, 0, 0, 0))
    z = jnp.zeros(7)
    rJi, rJj = jac(z, z, J(poses[ei]), J(poses[ej]), J(S_ji))
    rr = jax.vmap(jpg._edge_residual, in_axes=(None, None, 0, 0, 0))(z, z, J(poses[ei]), J(poses[ej]), J(S_ji))
    zt = torch.zeros(7)
    Ji, Jj = pose_graph._edge_jacobians(zt, zt, T(poses[ei]), T(poses[ej]), T(S_ji))
    r = pose_graph._edge_residual(zt, zt, T(poses[ei]), T(poses[ej]), T(S_ji))
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), atol=1e-4)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(rJi), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(rJj), atol=1e-4)
    np.testing.assert_allclose(pose_graph.relative_sim3(T(poses[ei]), T(poses[ej])).numpy(),
                               np.asarray(jax.vmap(jpg.relative_sim3)(J(poses[ei]), J(poses[ej]))), atol=1e-5)


def test_optimize_pose_graph_parity(rng):
    """20 LM iterations over 16 keyframes: corrected poses within 1e-4 of
    the reference's, and the loop error actually shrinks."""
    poses, true, (ei, ej, S_ji, weight, valid) = _graph(rng)
    fixed = np.arange(16) == 0
    ref = jpg.optimize_pose_graph(J(poses), J(fixed), jpg.PoseGraphEdges(J(ei), J(ej), J(S_ji), J(weight), J(valid)))
    got = pose_graph.optimize_pose_graph(
        T(poses), T(fixed), pose_graph.PoseGraphEdges(T(ei), T(ej), T(S_ji), T(weight), T(valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(got[0].numpy(), poses[0])

    def loop_err(p):
        return np.abs(p[15] @ np.linalg.inv(p[0]) - true[15] @ np.linalg.inv(true[0])).max()

    assert loop_err(got.numpy()) < 0.3 * loop_err(poses)  # measured 0.23, as the reference


def test_build_edges_from_map_parity(loop_states):
    """Edge lists of the loop state (tree, strong covisibility, a past loop
    edge, the new loop edge): indices and validity exact, measurements 1e-5."""
    jstate, tstate = loop_states
    jstate = jstate._replace(loop_edges=jstate.loop_edges.at[0].set(jnp.asarray([9, 2], jnp.int32)))
    le = tstate.loop_edges.clone()
    le[0] = torch.tensor([9, 2], dtype=torch.int32)
    tstate = tstate._replace(loop_edges=le)
    S = np.asarray(jlie.sim3_exp(J(np.array([0.1, 0, 0.05, 0, 0.02, 0, 0], np.float32))))
    ref = jpg.build_edges_from_map(jstate, jnp.int32(0), jnp.int32(16), J(S))
    got = pose_graph.build_edges_from_map(tstate, 0, 16, T(S))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.i.numpy()[ok], np.asarray(ref.i)[ok])
    np.testing.assert_array_equal(got.j.numpy()[ok], np.asarray(ref.j)[ok])
    np.testing.assert_array_equal(got.i.numpy(), np.asarray(ref.i))
    np.testing.assert_allclose(got.S_ji.numpy(), np.asarray(ref.S_ji), atol=1e-5)
    assert int(ok.sum()) > 20 and got.i.shape[0] == 32 * 32 + 1


# ---------------------------------------------------------------------------
# models/loop_closing.py
# ---------------------------------------------------------------------------

def test_loop_consistency_and_buckets():
    """The host-side pieces are copies: equal on a scripted sequence."""
    a, b = jlc.LoopConsistency(), lc.LoopConsistency()
    for groups in ([{1, 2}], [{2, 3}, {9}], [{3}, {9, 10}], [], [{3}]):
        assert a.update(list(groups)) == b.update(list(groups))
    for n in (0, 1, 15, 16, 17, 100, 5000):
        assert lc._bucket(n, 16, 128) == jlc._bucket(n, 16, 128)
        assert lc._bucket(n, 4096, 16384) == jlc._bucket(n, 4096, 16384)
    flag = lc.StopFlag()
    assert not flag
    flag.set(1)
    assert flag
    flag.clear()
    assert not flag


@pytest.mark.parametrize("use_voc", [False, True])
def test_match_keyframes_parity(loop_states, vocs, use_voc):
    """Keyframe 16 against keyframe 0 (the duplicated structure): identical
    ok masks, indices and distances; most matches are the true pairs."""
    jstate, tstate = loop_states
    jvoc, tvoc = vocs if use_voc else (None, None)
    ref = jlc.match_keyframes(jstate, jnp.int32(16), jnp.int32(0), jvoc)
    got = lc.match_keyframes(tstate, 16, 0, tvoc)
    ok = np.asarray(ref.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.idx.numpy()[ok], np.asarray(ref.idx)[ok])
    np.testing.assert_array_equal(got.dist.numpy()[ok], np.asarray(ref.dist)[ok])
    assert ok.sum() >= (40 if use_voc else 100)


def test_compute_sim3_parity(loop_states, loop_arrays, vocs):
    """ComputeSim3 of keyframe 16 against keyframe 0 with the reference's
    hypothesis sets injected: success, S12 within 1e-4, equal counts; S12
    is the drift between the passes."""
    jstate, tstate = loop_states
    jvoc, tvoc = vocs
    key = jax.random.key(16 * 131)
    ref = jlc.compute_sim3(jstate, jnp.int32(16), jnp.int32(0), J(K_NP), key, fix_scale=True, voc=jvoc)
    m = jlc.match_keyframes(jstate, jnp.int32(16), jnp.int32(0), jvoc)
    sets = _reference_sets(key, np.asarray(m.ok))
    got = lc.compute_sim3(tstate, 16, 0, T(K_NP), fix_scale=True, voc=tvoc, sets=T(sets))
    assert bool(ref[0]) and bool(got[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)
    assert int(got[2]) == int(ref[2]) and int(got[3]) == int(ref[3]) >= 40
    # S12 maps loop-camera to current-camera coordinates. Keyframes 16 and 0
    # stand in the same place, so it is the identity up to the drift that
    # still grows across keyframe 16's field of view (measured 0.046 m), while
    # the map's own relative pose between the two is off by the whole drift.
    arrays, D = loop_arrays
    np.testing.assert_allclose(got[1].numpy(), np.eye(4), atol=6e-2)
    drifted = arrays["kf_pose"][16] @ np.linalg.inv(arrays["kf_pose"][0])
    assert np.abs(drifted - np.eye(4)).max() > 0.15


@pytest.mark.parametrize("use_voc", [False, True])
def test_triangulate_candidates_with_vocabulary(loop_arrays, vocs, use_voc):
    """The triangulation search of keyframe 5 against keyframes 6 and 4 (0.2 m
    of baseline each) after their points from 40 on are forgotten: identical
    `good` masks and match indices where good, with and without the
    vocabulary's node mask; points within 1.5e-3 m (measured 5.2e-4: the
    linear triangulation of a point 5 m away over 0.2 m of baseline amplifies
    float32 rounding about 25 times). The mask prunes, and the points come
    back where they were (median within 0.25 m: 0.3 px of noise over that
    baseline is 0.1-0.2 m of depth)."""
    from orb_slam2v2_1_tpu.models import local_mapping as jlm
    from orb_slam2v2_1_tpu_torch.models import local_mapping

    arrays = {k: np.array(v) for k, v in loop_arrays[0].items()}
    arrays["kf_mp"][4:7, 40:] = -1
    jvoc, tvoc = vocs if use_voc else (None, None)
    kf2, pair_ok = np.array([6, 4], np.int32), np.array([True, True])
    jstate = jstate_of(arrays)
    ref = jax.vmap(lambda k, ok: jlm._triangulate_candidates(jstate, jnp.int32(5), k, ok, J(K_NP), jnp.float32(BF), jvoc))(
        J(kf2), J(pair_ok))  # the reference maps the single-pair search over the neighbours
    got = local_mapping._triangulate_candidates(tstate_of(arrays), 5, T(kf2.astype(np.int64)), T(pair_ok), T(K_NP), BF, tvoc)
    good = np.asarray(ref[0])
    np.testing.assert_array_equal(got[0].numpy(), good)
    np.testing.assert_array_equal(got[2].numpy()[good], np.asarray(ref[2])[good])
    np.testing.assert_allclose(got[1].numpy()[good], np.asarray(ref[1])[good], atol=1.5e-3)
    assert good.sum() >= (10 if use_voc else 40)
    if use_voc:
        plain = local_mapping._triangulate_candidates(tstate_of(arrays), 5, T(kf2.astype(np.int64)), T(pair_ok), T(K_NP), BF)
        assert good.sum() < int(plain[0].sum())
    was = loop_arrays[0]["mp_pos"][loop_arrays[0]["kf_mp"][5]]
    err = np.linalg.norm(got[1].numpy() - was[None], axis=-1)[good]
    assert np.median(err) < 0.25


def test_oldest_observer_parity(loop_states):
    jstate, tstate = loop_states
    np.testing.assert_array_equal(lc._oldest_observer(tstate).numpy(), np.asarray(jlc._oldest_observer(jstate)))


@pytest.fixture(scope="module")
def corrected(loop_states, vocs):
    """Both states after `correct_loop` with the reference's S12."""
    jstate, tstate = loop_states
    jvoc, _ = vocs
    _, S12, _, _ = jlc.compute_sim3(jstate, jnp.int32(16), jnp.int32(0), J(K_NP), jax.random.key(16 * 131),
                                    fix_scale=True, voc=jvoc)
    S12 = np.asarray(S12)
    jcopy = jax.tree.map(jnp.copy, jstate)
    return (jlc.correct_loop(jcopy, jnp.int32(16), jnp.int32(0), J(S12)),
            lc.correct_loop(tstate, 16, 0, T(S12)), S12)


def test_correct_loop_parity(corrected, loop_states, loop_arrays):
    """Essential-graph correction + point correction: translations and
    points within 1e-4, rotations within ROT_ATOL (measured 1.4e-4), integer
    fields (the recorded loop edge) exact; the input state is untouched; the
    drift at the loop is taken out."""
    jcor, tcor, _ = corrected
    assert_states_close(tcor, jcor, atol=1e-4, rot_atol=ROT_ATOL)
    assert tcor.loop_edges[0].tolist() == [16, 0] and int(tcor.n_loop_edges) == 1
    arrays, D = loop_arrays
    np.testing.assert_array_equal(loop_states[1].kf_pose.numpy(), arrays["kf_pose"])
    rel_true = arrays["kf_pose"][16] @ D @ np.linalg.inv(arrays["kf_pose"][0])  # drift-free relative pose
    rel_before = arrays["kf_pose"][16] @ np.linalg.inv(arrays["kf_pose"][0])
    rel_after = tcor.kf_pose[16].numpy() @ np.linalg.inv(tcor.kf_pose[0].numpy())
    assert np.abs(rel_after - rel_true).max() < 0.25 * np.abs(rel_before - rel_true).max()


def test_fuse_sizes_and_caps_parity(corrected):
    jcor, tcor, _ = corrected
    jn = jlc._fuse_sizes(jcor, jnp.int32(16), jnp.int32(0))
    tn = lc._fuse_sizes(tcor, 16, 0)
    assert [int(x) for x in tn] == [int(x) for x in jn]
    assert lc._fuse_caps(tcor, 16, 0) == jlc._fuse_caps(jcor, 16, 0)


@pytest.mark.parametrize("caps", [(16, 512), (8, 256)])
def test_search_and_fuse_parity(corrected, caps):
    """Loop fusion after the correction: identical kf_mp, mp_valid and
    n_fused (at caps that cover the sets and at caps that truncate them);
    duplicated landmarks are merged into the loop side's."""
    jcor, _, _ = corrected
    tcor = tstate_of(jarrays_of(jcor))  # the same corrected map into both
    jf, jn = jlc.search_and_fuse(jax.tree.map(jnp.copy, jcor), jnp.int32(16), jnp.int32(0), J(K_NP),
                                 fuse_kfs=caps[0], mp_cap=caps[1])
    tf, tn = lc.search_and_fuse(tcor, 16, 0, T(K_NP), fuse_kfs=caps[0], mp_cap=caps[1])
    assert int(tn) == int(jn) > 50
    assert_states_close(tf, jf, atol=0.0)
    assert int(tf.mp_valid.sum()) < int(tcor.mp_valid.sum())


def test_gba_problem_construction_parity(loop_states):
    """build_global_ba_problem / _compact / expand_gba_result /
    apply_global_ba_result: every index and mask exact, floats 1e-6."""
    jstate, tstate = loop_states
    jp = jlc.build_global_ba_problem(jstate, J(K_NP), jnp.float32(BF))
    tp = lc.build_global_ba_problem(tstate, T(K_NP), BF)
    jc, jslots, jused = jlc.build_global_ba_problem_compact(jstate, J(K_NP), jnp.float32(BF), 32)
    tc, tslots, tused = lc.build_global_ba_problem_compact(tstate, T(K_NP), BF, 32)
    for t_prob, j_prob in ((tp, jp), (tc, jc)):
        np.testing.assert_array_equal(t_prob.cam_fixed.numpy(), np.asarray(j_prob.cam_fixed))
        np.testing.assert_allclose(t_prob.poses.numpy(), np.asarray(j_prob.poses), atol=1e-6)
        for name in ("cam_idx", "pt_idx", "is_stereo", "valid"):
            np.testing.assert_array_equal(getattr(t_prob.obs, name).numpy(), np.asarray(getattr(j_prob.obs, name)), name)
        np.testing.assert_allclose(t_prob.obs.target.numpy(), np.asarray(j_prob.obs.target), atol=1e-6)
        np.testing.assert_allclose(t_prob.obs.inv_sigma2.numpy(), np.asarray(j_prob.obs.inv_sigma2), atol=1e-6)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
    opt = np.asarray(jc.poses) + 0.01
    jfull, jfixed = jlc.expand_gba_result(jstate.kf_pose, J(opt), jc.cam_fixed, jslots, jused)
    tfull, tfixed = lc.expand_gba_result(tstate.kf_pose, T(opt), tc.cam_fixed, tslots, tused)
    np.testing.assert_array_equal(tfixed.numpy(), np.asarray(jfixed))
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), atol=1e-6)
    japp = jlc.apply_global_ba_result(jstate, jfull, jstate.mp_pos + 0.5, jfixed)
    tapp = lc.apply_global_ba_result(tstate, tfull, tstate.mp_pos + 0.5, tfixed)
    assert_states_close(tapp, japp, atol=1e-6)


def _run_closer(closer_cls, db_module, voc, state, device_kw, as_id):
    """Feed keyframes 0-19 of the loop state through `on_keyframe`-style
    detection; returns the closer and the per-keyframe outcomes."""
    db = db_module.empty_database(32, 192, 10000, **device_kw)
    closer = closer_cls(voc, db, True, J(K_NP) if not device_kw else T(K_NP), BF)
    out = []
    for k in range(RING_KFS):
        out.append(closer.detect_loop(state, as_id(k), RING_KFS))
    return closer, out


def test_loop_closer_detects_the_same_loop(loop_states, vocs):
    """`LoopCloser.detect_loop` over the 20 keyframes in both packages: no
    trigger before the third consistent revisit, the same (keyframe,
    candidate) after it, S12 within 2e-3 although the RANSAC draws differ
    (the LM refinement ends in the same minimum); equal counters and
    databases."""
    jstate, tstate = loop_states
    jvoc, tvoc = vocs
    jcl, jout = _run_closer(jlc.LoopCloser, jkdb, jvoc, jstate, {}, int)
    tcl, tout = _run_closer(lc.LoopCloser, kdb, tvoc, tstate, {"device": "cpu"}, int)
    assert [o is None for o in tout] == [o is None for o in jout]
    hits = [k for k, o in enumerate(tout) if o is not None]
    assert hits and hits[0] == 18
    for k in hits:
        assert tout[k][0] == jout[k][0]
        np.testing.assert_allclose(tout[k][1].numpy(), np.asarray(jout[k][1]), atol=2e-3)
    assert tcl.kf_counter == jcl.kf_counter == RING_KFS
    assert_db_close(tcl.db, jcl.db)


def test_detect_batch_and_apply_closure(loop_states, vocs):
    """The chunked form on the port: keyframes registered in batches, one
    closure triggered (two keyframes earlier than one by one: a keyframe's
    detection sees the later keyframes of its batch, so the consistency chain
    starts at keyframe 14), later rounds of the batch suppressed and counted;
    `apply_closure` (inline global BA) leaves a finite map with the loop
    recorded, and `on_keyframe` returns to no detection inside the
    cooldown. The reference's `detect_batch` gives the same trigger."""
    jstate, tstate = loop_states
    jvoc, tvoc = vocs
    jcl = jlc.LoopCloser(jvoc, jkdb.empty_database(32, 192, 10000), True, J(K_NP), jnp.float32(BF))
    tcl = lc.LoopCloser(tvoc, kdb.empty_database(32, 192, 10000, device="cpu"), True, T(K_NP), BF)
    jtrig, ttrig = [], []
    for chunk in (list(range(0, 7)), list(range(7, 14)), list(range(14, 20))):
        jtrig += jcl.detect_batch(jstate, chunk, RING_KFS)
        ttrig += tcl.detect_batch(tstate, chunk, RING_KFS)
    assert len(ttrig) == len(jtrig) == 1
    assert ttrig[0][:2] == jtrig[0][:2] == (16, 0)
    assert tcl.n_detect_suppressed == jcl.n_detect_suppressed == 3
    np.testing.assert_allclose(ttrig[0][2].numpy(), np.asarray(jtrig[0][2]), atol=2e-3)
    assert_db_close(tcl.db, jcl.db)
    state = tcl.apply_closure(tstate, *ttrig[0])
    assert tcl.n_loops_closed == 1 and tcl.last_loop_seq == tcl.kf_counter
    assert torch.isfinite(state.kf_pose).all() and torch.isfinite(state.mp_pos).all()
    assert state.loop_edges[0].tolist() == [16, 0]
    assert int(state.mp_valid.sum()) < int(tstate.mp_valid.sum())
    state2, closed = tcl.on_keyframe(state, 19, RING_KFS)
    assert not closed and state2 is state


def test_mesh_of_several_devices_not_ported(loop_states):
    _, tstate = loop_states
    with pytest.raises(NotImplementedError):
        lc.run_global_bundle_adjustment(tstate, T(K_NP), BF, mesh=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError):
        lc.LoopCloser(None, None, True, T(K_NP), BF, mesh=[0, 1, 2, 3])
    with pytest.raises(NotImplementedError):
        lc.global_bundle_adjustment_dist(tstate, T(K_NP), BF, mesh=[0, 1])


# ---------------------------------------------------------------------------
# on the card: the functions that reach kernel 2, against the CPU plain path
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_compute_sim3_on_card(cuda_device, loop_arrays, vocs):
    """`compute_sim3` of keyframe 16 against keyframe 0 on the card (three
    kernel-2 searches) against the CPU plain path with the same hypothesis
    sets: same verdict and counts, S12 within 1e-4."""
    from orb_slam2v2_1_tpu_torch import kernels

    arrays, _ = loop_arrays
    cpu_state, cpu_voc = tstate_of(arrays), vocs[1]
    gpu_state = map_state.from_numpy(arrays, device=cuda_device)
    gpu_voc = vocab.load_vocabulary(np.load(VOCAB_NPZ), device=cuda_device)
    sets = sim3solver.hypothesis_sets(lc.match_keyframes(cpu_state, 16, 0, cpu_voc).ok, torch.Generator().manual_seed(16 * 131))
    ref = lc.compute_sim3(cpu_state, 16, 0, T(K_NP), voc=cpu_voc, sets=sets)
    kernels.reset_launch_counts()
    got = lc.compute_sim3(gpu_state, 16, 0, T(K_NP).to(cuda_device), voc=gpu_voc, sets=sets.to(cuda_device))
    assert kernels.LAUNCHES["masked_best_two"] == 3
    assert bool(got[0]) and bool(ref[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].numpy(), atol=1e-4)
    assert int(got[2]) == int(ref[2]) and int(got[3]) == int(ref[3])
    # With a generator on the card the draws are the card's own: still a success.
    gen = torch.Generator(device=cuda_device).manual_seed(16 * 131)
    assert bool(lc.compute_sim3(gpu_state, 16, 0, T(K_NP).to(cuda_device), gen, voc=gpu_voc)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(16, 512), (8, 256)])
def test_search_and_fuse_on_card(cuda_device, corrected, caps):
    """`search_and_fuse` on the card (one batched kernel-2 search) against
    the CPU plain path on the same corrected map: identical kf_mp, mp_valid
    and n_fused."""
    from orb_slam2v2_1_tpu_torch import kernels

    arrays = jarrays_of(corrected[0])
    ref, n_ref = lc.search_and_fuse(tstate_of(arrays), 16, 0, T(K_NP), fuse_kfs=caps[0], mp_cap=caps[1])
    kernels.reset_launch_counts()
    got, n_got = lc.search_and_fuse(map_state.from_numpy(arrays, device=cuda_device), 16, 0, T(K_NP).to(cuda_device),
                                    fuse_kfs=caps[0], mp_cap=caps[1])
    assert kernels.LAUNCHES["masked_best_two"] == 1
    assert int(n_got) == int(n_ref) > 50
    got_np, ref_np = map_state.to_numpy(got), map_state.to_numpy(ref)
    np.testing.assert_array_equal(got_np["kf_mp"], ref_np["kf_mp"])
    np.testing.assert_array_equal(got_np["mp_valid"], ref_np["mp_valid"])
