"""CTR models: Wide&Deep and DeepFM over high-dim sparse id features.

Reference: python/paddle/fluid/tests/unittests/dist_ctr.py (dnn+lr over
sparse embeddings trained through the parameter-server path) and the
BASELINE.json "DeepFM / Wide&Deep CTR" workload. The reference streams
SelectedRows sparse grads to pservers; in the port the embedding grad is
a fixed-order row sum on the one card (``lookup_table``'s grad
lowering). A copy of the JAX package's model.

Feeds are statically shaped: sparse ids [B, n_fields] int64 (one id per
field slot), dense features [B, n_dense] float32, label [B,1] int64.
"""

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["wide_deep", "deepfm", "build"]


def _field_embed(ids, vocab, dim, name, distributed=False):
    """[B,F] ids -> [B,F,dim] via one shared table (hash-bucketed slots).
    distributed=True marks the lookup for the PS sparse-table path: the
    transpiler rewrites it to prefetch (remote row fetch) + send_sparse
    (SelectedRows grads), and the table lives ONLY on its pserver —
    reference dist_ctr.py / distribute_lookup_table flow."""
    return layers.embedding(ids, size=[vocab, dim],
                            is_sparse=distributed,
                            is_distributed=distributed,
                            param_attr=ParamAttr(name=name))


def wide_deep(sparse_ids, dense, vocab=1000001, emb_dim=16,
              hidden=(400, 400, 400), distributed=False):
    n_fields = sparse_ids.shape[1]
    # deep: field embeddings concat + MLP
    emb = _field_embed(sparse_ids, vocab, emb_dim, "deep_emb",
                       distributed=distributed)
    deep = layers.reshape(emb, [-1, n_fields * emb_dim])
    deep = layers.concat([deep, dense], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(deep, h, act="relu",
                         param_attr=ParamAttr(name="deep_fc%d.w_0" % i))
    # wide: linear over sparse (dim-1 embedding = per-id weight) + dense
    wide_emb = _field_embed(sparse_ids, vocab, 1, "wide_emb",
                            distributed=distributed)
    wide = layers.reshape(wide_emb, [-1, n_fields])
    wide = layers.concat([wide, dense], axis=1)
    both = layers.concat([deep, wide], axis=1)
    return layers.fc(both, 2, act="softmax",
                     param_attr=ParamAttr(name="pred.w_0"))


def deepfm(sparse_ids, dense, vocab=1000001, emb_dim=16,
           hidden=(400, 400), distributed=False):
    n_fields = sparse_ids.shape[1]
    # first order
    w1 = _field_embed(sparse_ids, vocab, 1, "fm_w1",
                      distributed=distributed)           # [B,F,1]
    first = layers.reduce_sum(layers.reshape(w1, [-1, n_fields]), dim=1,
                              keep_dim=True)                   # [B,1]
    # second order: 0.5 * ((sum_f v)^2 - sum_f v^2)
    v = _field_embed(sparse_ids, vocab, emb_dim, "fm_v",
                     distributed=distributed)             # [B,F,k]
    sum_v = layers.reduce_sum(v, dim=1)                        # [B,k]
    sum_sq = layers.elementwise_mul(sum_v, sum_v)
    sq_sum = layers.reduce_sum(layers.elementwise_mul(v, v), dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), scale=0.5)           # [B,1]
    # deep over the same embeddings
    deep = layers.reshape(v, [-1, n_fields * emb_dim])
    deep = layers.concat([deep, dense], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(deep, h, act="relu",
                         param_attr=ParamAttr(name="dfm_fc%d.w_0" % i))
    deep_out = layers.fc(deep, 1, param_attr=ParamAttr(name="dfm_out.w_0"))
    logit = layers.elementwise_add(layers.elementwise_add(first, second),
                                   deep_out)                   # [B,1]
    prob = layers.sigmoid(logit)
    # 2-class probs for accuracy/auc parity with dist_ctr
    one = layers.fill_constant([1], "float32", 1.0)
    return layers.concat([layers.elementwise_sub(one, prob), prob], axis=1)


def build(model="deepfm", n_fields=26, n_dense=13, vocab=1000001,
          emb_dim=16, distributed=False):
    sparse_ids = layers.data("sparse_ids", [n_fields], dtype="int64")
    dense = layers.data("dense", [n_dense])
    label = layers.data("label", [1], dtype="int64")
    fn = deepfm if model == "deepfm" else wide_deep
    probs = fn(sparse_ids, dense, vocab=vocab, emb_dim=emb_dim,
               distributed=distributed)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc, [sparse_ids, dense, label]
