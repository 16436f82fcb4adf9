"""The initial-weight check of ``tests/test_torch_train.py`` and
``tests/test_torch_branches.py``: a port module's parameters, as drawn by
one of its init functions, against the variables flax's ``model.init``
gave the JAX module, leaf by leaf (numpy only; the callers hand it JAX's
variables already on the host).

  * a leaf that JAX's init gives one value throughout (ones, zeros, a bias
    constant) must be equal exactly;
  * for every other leaf the sample std must lie within 5 standard errors
    (std / sqrt(2n), JAX's std) of JAX's; leaves of fewer than 64 entries
    are pooled with the other small leaves of their rule first;
  * a flax ``kernel`` (``nn.Dense`` / ``nn.Conv``: lecun_normal, a normal
    cut at +-2 sigma) must have no entry beyond 2 sigma = 2 sqrt(1 /
    fan_in) / 0.8796 (fan_in as flax counts it: every axis but the last),
    and neither may JAX's; any other random leaf of 256 entries or more
    must have one (JAX's has: an untruncated normal);
  * buffers must equal JAX's non-param collections exactly.
"""

import numpy as np

TRUNC_STD = 0.87962566103423978
POOL_BELOW = 64


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _rule(path, arr):
    """(rule name, pooling key, fan_in or None) of a JAX params leaf."""
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(arr.shape[:-1]))
        return "lecun_normal", ("lecun_normal", fan_in), fan_in
    if arr.ndim == 5:                       # sparse conv (3, 3, 3, Ci, Co)
        fan_in = int(np.prod(arr.shape[:-1]))
        return "variance_scaling", ("variance_scaling", fan_in), fan_in
    return "normal", ("normal", leaf), None


def init_rejections(module, variables, from_flax):
    """Compare ``module``'s parameters and buffers with JAX's ``variables``
    (host numpy dicts).  Returns (rejections, pooled): the leaves that
    fail, in the module's parameter order, each ``(name, why)``; and the
    pools of small leaves, ``{rule key: [names]}``."""
    port = {n: p.detach().cpu().double().numpy()
            for n, p in module.named_parameters()}
    jax_sd = from_flax(variables)
    params = variables["params"]
    rules = {}
    for path, arr in _flat(params):
        rules[".".join(path[:-1] + (
            {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1]),))
              ] = _rule(path, arr)
    if set(rules) != set(port):
        return [("<names>", f"port only {sorted(set(port) - set(rules))}, "
                            f"JAX only {sorted(set(rules) - set(port))}")], {}
    rejections = []
    for name, b in module.named_buffers():
        a = jax_sd.get(name)
        if a is None or not np.array_equal(b.cpu().numpy(), a.numpy()):
            rejections.append((name, "buffer differs from JAX's"))
    small = {}
    for name, got in port.items():
        ref = jax_sd[name].double().numpy()
        rule, key, fan_in = rules[name]
        if np.all(ref == ref.flat[0]):
            if not np.array_equal(got, ref):
                rejections.append((name, f"JAX constant {ref.flat[0]}, port "
                                         f"spans [{got.min()}, {got.max()}]"))
            continue
        if ref.size < POOL_BELOW:
            small.setdefault(key, []).append(name)
        else:
            why = _std_rejection(got.ravel(), ref.ravel())
            if why:
                rejections.append((name, why))
        why = _tail_rejection(rule, fan_in, got, ref)
        if why:
            rejections.append((name, why))
    for key, names in small.items():
        why = _std_rejection(np.concatenate([port[n].ravel() for n in names]),
                             np.concatenate([jax_sd[n].double().numpy().ravel()
                                             for n in names]))
        if why:
            rejections.append((f"pool {key}: {names}", why))
    return rejections, small


def _std_rejection(got, ref):
    s_ref, s_got = float(ref.std()), float(got.std())
    se = s_ref / np.sqrt(2 * ref.size)
    if abs(s_got - s_ref) > 5 * se:
        return (f"std {s_got:.6g} vs JAX {s_ref:.6g}: "
                f"{abs(s_got - s_ref) / se:.1f} standard errors")
    return None


def _tail_rejection(rule, fan_in, got, ref):
    if rule == "lecun_normal":
        bound = 2.0 * np.sqrt(1.0 / fan_in) / TRUNC_STD
        assert np.abs(ref).max() <= bound * (1 + 1e-6), \
            "JAX's lecun_normal leaf exceeds its own cut"
        if np.abs(got).max() > bound * (1 + 1e-6):
            return (f"max |w| {np.abs(got).max():.6g} beyond the 2 sigma "
                    f"cut {bound:.6g}")
    elif ref.size >= 256:
        beyond = lambda x: np.abs(x).max() > 2.0 * ref.std()
        assert beyond(ref), "JAX's untruncated leaf has no entry past 2 sigma"
        if not beyond(got):
            return "no entry past 2 sigma: truncated, JAX's is not"
    return None
