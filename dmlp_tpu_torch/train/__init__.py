"""Train extension — port of ``dmlp_tpu/train``.

The north star's distributed substrate carrying a training loop: an MLP
classifier over the engine's attribute-vector records
(:mod:`.model`), an eager train step whose dp gradient sync is an explicit
all-reduce and whose tensor parallelism is DTensor's (:mod:`.step`,
:mod:`.sharding`), host offload of parameters and moments, DCP checkpoint
and resume (:mod:`.checkpoint`), samples/s/chip and MFU
(:mod:`.metrics`), the loop CLI with the NaN guard (:mod:`.loop`) and the
benchmark (:mod:`.bench`); the pipeline families (GPipe, interleaved, dp x
tp x pp, :mod:`.pipeline`) and the MoE families (dense and all-to-all
dispatch, :mod:`.experts`) over the autograd collectives of
:mod:`.collectives`, the multi-rank dry run (:mod:`.dryrun`) and the
weak-scaling sweep (:mod:`.sweep`).
"""

from dmlp_tpu_torch.train.model import init_mlp, mlp_apply  # noqa: F401
from dmlp_tpu_torch.train.step import TrainState, make_train_step  # noqa: F401
