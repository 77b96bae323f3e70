"""repro_torch.rsa — Representational Similarity Analysis (paper §4.2).

Cross-validated condition dissimilarities (pairwise-contrast or confusion
RDMs) from shared :class:`~repro_torch.core.fastcv.CVPlan` fold solves,
model-RDM scoring with rank correlations and condition-permutation nulls,
pattern RDMs on the hand-written ``pairdist`` kernel, and mesh-sharded
searchlight sweeps.

  rdm      empirical RDMs from CVPlan fold solves; pattern RDMs;
           searchlight sharding.
  compare  Spearman/Kendall/Pearson/cosine model scoring + permutation nulls.
"""

from repro_torch.rsa.compare import (  # noqa: F401
    compare_rdms,
    cosine,
    kendall,
    make_compare,
    make_compare_null,
    pearson,
    permutation_null,
    rankdata,
    spearman,
    upper_triangle,
)
from repro_torch.rsa.rdm import (  # noqa: F401
    condition_means,
    condition_pairs,
    euclidean_rdm,
    make_eval_pairs,
    pair_contrast_columns,
    pair_dissimilarities,
    rdm_binary,
    rdm_from_confusion,
    rdm_from_pair_values,
    rdm_multiclass,
    ring_rdm,
    searchlight_rdm,
)
