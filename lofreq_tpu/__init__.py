"""lofreq_tpu — a JAX LoFreq-class variant-calling engine for the GPU.

Brand-new implementation of the capabilities of CSB5/lofreq (v2.1.5):
ultra-sensitive, quality-aware SNV + indel calling with no allele-frequency
cutoff.  Instead of the reference's per-read callback design
(/root/reference/src/lofreq/plp.c:1293), pileup columns are packed into dense
per-column tensors and the statistical core — the Poisson-binomial
significance DP (snpcaller.c:830), quality merging (snpcaller.c:302), the BAQ
forward/backward HMM (kprobaln_ext.c:80) and Viterbi realignment
(viterbi.c:99) — runs as batched kernels over thousands of columns/reads per
device step, with exact float64 confirmation of candidate calls on host and
Bonferroni/FDR correction + VCF emission on host.
"""

__version__ = "0.1.0"
