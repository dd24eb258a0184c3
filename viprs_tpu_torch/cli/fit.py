"""viprs_fit_torch — fit PRS models to GWAS summary statistics on the card.

The port's counterpart of viprs_tpu.cli.fit (``viprs_fit``), with the same
flags and outputs: read the LD stores and the summary statistics, harmonize
the alleles, pack the LD (through the packed-LD cache), fit on the device,
and write ``<prefix>.fit.gz``, ``<prefix>.hyp``, ``<prefix>.validation``
(grid search) and ``<prefix>.prof`` (``--output-profiler-metrics``). numpy,
the standard library and torch only: no pandas, no JAX.

``--device`` (default ``cuda``) names the device; without CUDA the command
fails unless ``--device cpu`` was asked for (the plain PyTorch versions of
the kernels). All chromosomes are fit jointly, or, when the packed LD
exceeds the device budget (``--device-memory-gb``, else 65% of the card's
memory), one group of chromosomes at a time. ``--grid-metric validation``
scores the grid on ``--validation-bed`` genotypes (decoded on
``--device``) against ``--validation-pheno``. ``--mesh NBxNG`` (or
``auto`` with several processes) runs the fit over the processes of a
``torchrun`` launch (``parallel.init_distributed``): every rank reads the
data and holds it on the host, its card gets its shard of the LD, and
only rank 0 writes the outputs and the log.
``--float-precision`` goes to the models, which keep float32 state either
way (it sets their ``float_eps``, as in the JAX package).

    python -m viprs_tpu_torch.cli.fit -l <LD store> -s <sumstats> \\
        --output-file <prefix> [--device cpu]
    torchrun --nproc-per-node 2 -m viprs_tpu_torch.cli.fit ... --mesh 2x1
"""

import argparse
import logging
import os
import os.path as osp
import sys
import time

import numpy as np

logger = logging.getLogger("viprs_fit")


def build_parser():
    parser = argparse.ArgumentParser(
        prog='viprs_fit_torch',
        description="Fit variational Bayesian PRS models (the PyTorch/CUDA "
                    "port of viprs_tpu).")

    # ------------------------------ data ------------------------------
    parser.add_argument('-l', '--ld-panel', dest='ld_dir', required=True,
                        help="Path (or glob) to the LD store directory/directories.")
    parser.add_argument('-s', '--sumstats', dest='sumstats_path', required=True,
                        help="Path (or glob) to the GWAS summary statistics file(s).")
    parser.add_argument('--sumstats-format', dest='sumstats_format',
                        default='magenpy',
                        choices=['plink1.9', 'plink2', 'cojo', 'magenpy', 'fastgwa',
                                 'ssf', 'gwas-ssf', 'gwascatalog', 'saige', 'custom'])
    parser.add_argument('--custom-sumstats-mapper', dest='custom_mapper', default=None,
                        help="Comma-separated file_col=canonical_col pairs for "
                             "--sumstats-format custom.")
    parser.add_argument('--custom-sumstats-sep', dest='custom_sep', default=None,
                        help="Field separator for custom-format sumstats.")
    parser.add_argument('--gwas-sample-size', dest='gwas_n', type=float, default=None,
                        help="Fallback GWAS sample size when the file lacks N.")
    parser.add_argument('--extract', dest='extract_file', default=None,
                        help="File with variant IDs to restrict the analysis to.")
    parser.add_argument('--exclude-lrld', dest='exclude_lrld', action='store_true',
                        help="Exclude long-range LD regions.")
    parser.add_argument('--block-size', dest='block_size', type=int, default=1024,
                        help="LD tile size (multiple of 128).")
    parser.add_argument('--dequantize-on-the-fly', dest='dequantize',
                        action='store_true',
                        help="Keep LD int8-quantized on the device (the kernels "
                             "dequantize it); default float32 tiles.")

    # ------------------------------ model -----------------------------
    parser.add_argument('-m', '--model', dest='model', default='VIPRS',
                        choices=['VIPRS', 'VIPRSMix', 'VIPRSGrid'])
    parser.add_argument('--n-components', dest='n_components', type=int, default=3,
                        help="Number of slab components for VIPRSMix.")
    parser.add_argument('--hyp-search', dest='hyp_search', default='EM',
                        choices=['EM', 'GS', 'BMA'],
                        help="EM: learn hyperparameters; GS: grid search; "
                             "BMA: Bayesian model averaging over the grid.")
    parser.add_argument('--grid-metric', dest='grid_metric', default='ELBO',
                        choices=['ELBO', 'validation', 'pseudo_validation'])
    parser.add_argument('--pathwise', dest='pathwise', action='store_true',
                        help="Serial warm-started grid schedule instead of the "
                             "simultaneous fit of all grid points.")
    parser.add_argument('--grid-search-mode', dest='grid_search_mode',
                        default=None, choices=['pathwise', 'simultaneous'],
                        help="Alias for --pathwise (reference flag).")

    # grid specification:
    parser.add_argument('--pi-grid', dest='pi_grid', default=None,
                        help="Comma-separated grid values for pi.")
    parser.add_argument('--pi-steps', dest='pi_steps', type=int, default=None)
    parser.add_argument('--sigma-epsilon-grid', dest='sigma_epsilon_grid', default=None)
    parser.add_argument('--sigma-epsilon-steps', dest='sigma_epsilon_steps',
                        type=int, default=None)
    parser.add_argument('--tau-beta-grid', dest='tau_beta_grid', default=None)
    parser.add_argument('--tau-beta-steps', dest='tau_beta_steps', type=int,
                        default=None)
    parser.add_argument('--lambda-min-steps', dest='lambda_min_steps', type=int,
                        default=None)
    parser.add_argument('--h2-est', dest='h2_est', type=float, default=None)
    parser.add_argument('--h2-se', dest='h2_se', type=float, default=None)

    # fixed hyperparameters:
    parser.add_argument('--fix-pi', dest='fix_pi', type=float, default=None)
    parser.add_argument('--fix-sigma-epsilon', dest='fix_sigma_epsilon',
                        type=float, default=None)
    parser.add_argument('--fix-tau-beta', dest='fix_tau_beta', type=float,
                        default=None)
    parser.add_argument('--lambda-min', dest='lambda_min', default=None,
                        help="Numeric value or 'infer'.")

    # ---------------------------- validation --------------------------
    parser.add_argument('--validation-bed', '--validation-bfile',
                        dest='validation_bed', default=None,
                        help="BED fileset with individual-level validation "
                             "data (for --grid-metric validation).")
    parser.add_argument('--validation-pheno', dest='validation_pheno', default=None)
    parser.add_argument('--validation-keep', dest='validation_keep', default=None)
    parser.add_argument('--validation-sumstats', dest='validation_sumstats',
                        default=None,
                        help="Independent sumstats for pseudo-validation.")
    parser.add_argument('--validation-sumstats-format',
                        dest='validation_sumstats_format', default=None,
                        help="Format of the validation sumstats (defaults to "
                             "--sumstats-format).")
    parser.add_argument('--validation-custom-sumstats-mapper',
                        dest='validation_custom_mapper', default=None,
                        help="Comma-separated file_col=canonical_col pairs for "
                             "custom-format validation sumstats.")
    parser.add_argument('--validation-custom-sumstats-sep',
                        dest='validation_custom_sep', default=None,
                        help="Field separator for custom-format validation "
                             "sumstats.")
    parser.add_argument('--validation-gwas-sample-size',
                        dest='validation_gwas_n', type=float, default=None)
    parser.add_argument('--validation-ld-panel', dest='validation_ld_panel',
                        default=None,
                        help="Accepted for reference compatibility; the "
                             "training LD panel is reused for pseudo-validation.")
    parser.add_argument('--prop-train', dest='prop_train', type=float, default=0.8,
                        help="PUMAS training proportion when splitting sumstats.")

    # ------------------------------- fit ------------------------------
    parser.add_argument('--max-iter', dest='max_iter', type=int, default=1000)
    parser.add_argument('--min-iter', dest='min_iter', type=int, default=3)
    parser.add_argument('--f-abs-tol', dest='f_abs_tol', type=float, default=1e-6)
    parser.add_argument('--x-abs-tol', dest='x_abs_tol', type=float, default=1e-6)
    parser.add_argument('--patience', dest='patience', type=int, default=10)
    parser.add_argument('--float-precision', dest='float_precision',
                        default='float32', choices=['float32', 'float64'])
    parser.add_argument('--sweep-impl', dest='sweep_impl', default='auto',
                        choices=['auto', 'xla', 'pallas', 'skip', 'hybrid'],
                        help="E-step sweep rule (model/_dispatch.py): 'auto' "
                             "(default) the port's policy; 'xla'/'pallas' "
                             "every block every iteration, 'skip' the "
                             "activity-gated sweep, 'hybrid' the single-model "
                             "VIPRS dispatch between the two.")
    parser.add_argument('--hybrid-eps', dest='hybrid_eps', type=float,
                        default=None,
                        help="Proposal-mask gate epsilon for the hybrid "
                             "dispatch. Default: the fit's --x-abs-tol.")
    parser.add_argument('--threads', dest='threads', type=int, default=1,
                        help="Accepted for compatibility.")
    parser.add_argument('--n-jobs', dest='n_jobs', type=int, default=1,
                        help="Accepted for compatibility; chromosomes are fit "
                             "jointly.")
    parser.add_argument('--device-memory-gb', dest='device_memory_gb',
                        type=float, default=None,
                        help="Device memory budget for the LD capacity "
                             "planner. When the packed LD exceeds 65%% of it, "
                             "the fit streams over chromosome groups (the "
                             "reference's per-chromosome mode, "
                             "bin/viprs_fit:232-238). Default: the card's "
                             "memory on CUDA; no streaming on the CPU.")
    parser.add_argument('--mesh', dest='mesh', default='auto',
                        help="'auto' (default: every process on the blocks "
                             "axis when torchrun starts several, else one "
                             "device), 'off', or '<NB>x<NG>' (the blocks "
                             "and grid axes; their product is the number "
                             "of processes).")
    parser.add_argument('--device', dest='device', default='cuda',
                        help="Device of the fit: 'cuda' (default; fails "
                             "without CUDA) or 'cpu'.")
    parser.add_argument('--genomewide', dest='genomewide', action='store_true',
                        help="Accepted for compatibility (always genome-wide).")
    parser.add_argument('--backend', dest='backend', default='xarray',
                        help="Accepted for compatibility; data IO is native.")
    parser.add_argument('--temp-dir', dest='temp_dir', default='temp',
                        help="Accepted for compatibility.")
    parser.add_argument('--use-symmetric-ld', dest='use_symmetric_ld',
                        action='store_true',
                        help="Accepted for compatibility; the dense LD tiles "
                             "are symmetric by construction.")

    # ------------------------------ output ----------------------------
    parser.add_argument('--output-file', dest='output_file', default=None,
                        help="Output prefix (writes <prefix>.fit.gz etc.).")
    parser.add_argument('--output-dir', dest='output_dir', default=None,
                        help="Output directory (reference-style; combine with "
                             "--output-file-prefix).")
    parser.add_argument('--output-file-prefix', dest='output_prefix',
                        default='VIPRS',
                        help="Output file prefix when using --output-dir.")
    parser.add_argument('--output-profiler-metrics', dest='profiler',
                        action='store_true')
    parser.add_argument('--log-level', dest='log_level', default='WARNING')
    parser.add_argument('--seed', dest='seed', type=int, default=None)

    return parser


def _parse_grid_values(s):
    return np.array([float(v) for v in s.split(',')]) if s else None


def check_args(args):
    """Resolve the argument aliases and refuse what the port has not
    ported (before any data is read)."""
    if args.output_file is None:
        if not args.output_dir:
            raise ValueError("Provide --output-file or --output-dir.")
        args.output_file = osp.join(args.output_dir, args.output_prefix)
    if args.grid_search_mode == 'pathwise':
        args.pathwise = True
    if args.hyp_search in ('GS', 'BMA') and args.model != 'VIPRSGrid':
        args.model = 'VIPRSGrid'
    if args.model == 'VIPRSGrid' and args.hyp_search == 'EM':
        args.hyp_search = 'GS'
    if args.model == 'VIPRSGrid':
        has_grid = any([args.pi_grid, args.pi_steps, args.sigma_epsilon_grid,
                        args.sigma_epsilon_steps, args.tau_beta_grid,
                        args.tau_beta_steps, args.lambda_min_steps])
        if not has_grid:
            args.pi_steps = 10
    if args.grid_metric == 'validation' and not (args.validation_bed and
                                                 args.validation_pheno):
        raise ValueError("--grid-metric validation requires --validation-bed "
                         "and --validation-pheno")
    return args


def resolve_device(name):
    """The torch device of ``--device``: CUDA must be present for a CUDA
    device (the CLI never falls back to the CPU)."""
    import torch
    dev = torch.device(name)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda (the default) needs a CUDA card, and "
                "torch.cuda.is_available() is false; pass --device cpu to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f"--device must be cuda or cpu; got {name!r}")
    return dev


def _read_ids(path):
    """The first column of a whitespace-separated file without header."""
    with open(path) as f:
        return [line.split()[0] for line in f if line.strip()]


def read_keep_ids(path):
    """The sample IDs of a --keep file: the set of its last column, as
    strings (headerless, whitespace-separated)."""
    from ..utils.table import read_table
    t = read_table(path, header=False)
    return set(t[t.columns[-1]].astype(str).tolist())


def init_data(args, device):
    """The training loader, the validation loader of ``--validation-bed``
    (genotypes on ``device``; None without it) and the validation
    statistics of ``--validation-sumstats`` (or None)."""
    from ..data.loader import GWADataLoader
    from ..data.sumstats import read_sumstats

    kwargs = {}
    if args.custom_mapper:
        kwargs['column_map'] = dict(kv.split('=')
                                    for kv in args.custom_mapper.split(','))
    if args.custom_sep:
        kwargs['sep'] = args.custom_sep

    loader = GWADataLoader(
        ld_store_files=args.ld_dir,
        sumstats_files=args.sumstats_path,
        sumstats_format=args.sumstats_format,
        n=args.gwas_n,
        block_size=args.block_size,
        quantize_ld=args.dequantize,
        **kwargs)

    if args.extract_file:
        loader.filter_snps(_read_ids(args.extract_file))
    if args.exclude_lrld:
        loader.filter_long_range_ld_regions()

    validation_gdl = None
    if args.validation_bed:
        keep = None
        if args.validation_keep:
            keep = read_keep_ids(args.validation_keep)
        validation_gdl = GWADataLoader(
            bed_files=args.validation_bed,
            phenotype_file=args.validation_pheno,
            keep_samples=keep, device=device)

    validation_ss = None
    if args.validation_sumstats:
        vkwargs = {}
        if args.validation_custom_mapper:
            vkwargs['column_map'] = dict(
                kv.split('=') for kv in args.validation_custom_mapper.split(','))
        if args.validation_custom_sep:
            vkwargs['sep'] = args.validation_custom_sep
        validation_ss = read_sumstats(
            args.validation_sumstats,
            sumstats_format=args.validation_sumstats_format or args.sumstats_format,
            n=args.validation_gwas_n or args.gwas_n,
            **vkwargs)

    return loader, validation_gdl, validation_ss


def prepare_model(args, dataset, device, mesh=None):
    from ..gridsearch import HyperparameterGrid
    from ..model import VIPRS, VIPRSGrid, VIPRSMix

    fix_params = {}
    if args.fix_pi is not None:
        fix_params['pi'] = args.fix_pi
    if args.fix_sigma_epsilon is not None:
        fix_params['sigma_epsilon'] = args.fix_sigma_epsilon
    if args.fix_tau_beta is not None:
        fix_params['tau_beta'] = args.fix_tau_beta

    lam = args.lambda_min
    if lam is not None and lam != 'infer':
        lam = float(lam)

    if args.model == 'VIPRS':
        return VIPRS(dataset, device, lambda_min=lam, fix_params=fix_params,
                     float_precision=args.float_precision, mesh=mesh)
    if args.model == 'VIPRSMix':
        # the JAX CLI passes the mixture no float_precision
        return VIPRSMix(dataset, device, K=args.n_components,
                        fix_params=fix_params,
                        lambda_min=None if lam == 'infer' else lam,
                        mesh=mesh)

    from ..data.ldsc import simple_ldsc
    try:
        h2_est = args.h2_est or float(np.clip(simple_ldsc(dataset), 0.01, 0.99))
    except Exception:
        h2_est = 0.1
    grid = HyperparameterGrid(
        sigma_epsilon_grid=_parse_grid_values(args.sigma_epsilon_grid),
        sigma_epsilon_steps=args.sigma_epsilon_steps,
        tau_beta_grid=_parse_grid_values(args.tau_beta_grid),
        tau_beta_steps=args.tau_beta_steps,
        pi_grid=_parse_grid_values(args.pi_grid),
        pi_steps=args.pi_steps,
        lambda_min_steps=args.lambda_min_steps,
        h2_est=h2_est, h2_se=args.h2_se,
        n_snps=dataset.m)
    return VIPRSGrid(dataset, grid, device, lambda_min=lam,
                     fix_params=fix_params,
                     float_precision=args.float_precision, mesh=mesh)


def fit_model(args, model, validation_gdl, validation_ss):
    """The fit of viprs_fit (viprs_tpu/cli/fit.py:337-400): the PUMAS split
    where the grid is selected by pseudo-validation without validation
    data, the fit, one retry with the inferred lambda_min on the
    reference's divergence signature, then BMA or selection (and the refit
    of the selected model on the full statistics after a split). Returns
    (model, fit seconds)."""
    from ..gridsearch import bayesian_model_average, select_best_model
    from ..model import VIPRS

    pumas_split = (args.model == 'VIPRSGrid'
                   and args.grid_metric == 'pseudo_validation'
                   and validation_gdl is None and validation_ss is None)
    if pumas_split:
        logger.info("> No validation data provided; splitting the GWAS summary "
                    "statistics (PUMAS).")
        model.split_gwas_sumstats(prop_train=args.prop_train, seed=args.seed)

    fit_kwargs = dict(max_iter=args.max_iter, min_iter=args.min_iter,
                      f_abs_tol=args.f_abs_tol,
                      x_abs_tol=args.x_abs_tol, patience=args.patience)
    pathwise = args.model == 'VIPRSGrid' and args.pathwise
    if args.model != 'VIPRSMix' and not pathwise:
        # live ELBO progress on interactive runs, quiet in pipelines (the
        # JAX CLI passes it to every model; only these fits read it)
        fit_kwargs['disable_pbar'] = not sys.stderr.isatty()
    if args.sweep_impl != 'auto' and not pathwise:
        fit_kwargs['sweep_impl'] = args.sweep_impl
    if args.hybrid_eps is not None and args.model == 'VIPRS':
        # the gate epsilon is a single-model VIPRS knob
        fit_kwargs['hybrid_eps'] = args.hybrid_eps
    if args.model == 'VIPRSGrid':
        fit_kwargs['pathwise'] = pathwise

    t0 = time.time()
    model.fit(**fit_kwargs)
    if model.optim_result.error_on_termination:
        # the reference's one automatic retry, on sigma_g < 0 with no
        # spectral regularization applied (bin/viprs_fit:509-521); anything
        # else, and a mixture fit (which has neither sigma_g nor fixed
        # lambda_min), is an error of its own
        if (isinstance(model, VIPRS)
                and np.any(np.atleast_1d(model.sigma_g) < 0)
                and np.all(np.atleast_1d(model.lambda_min) == 0.0)):
            logger.warning("> Optimization diverged; retrying with inferred "
                           "lambda_min (reference behavior).")
            model.set_fixed_params({'lambda_min': model.infer_lambda_min()})
            model.fit(**fit_kwargs)
        else:
            raise RuntimeError(model.optim_result.message)
    fit_time = time.time() - t0

    if args.model == 'VIPRSGrid':
        if args.hyp_search == 'BMA':
            bayesian_model_average(model)
        else:
            vgdl = validation_gdl
            if args.grid_metric == 'pseudo_validation' \
                    and validation_ss is not None:
                # harmonize the validation statistics onto the model's
                # variants
                model.set_validation_sumstats(validation_ss)
                vgdl = None
            select_best_model(model, validation_gdl=vgdl,
                              criterion=args.grid_metric)
            if pumas_split:
                logger.info("> Restoring full summary statistics and "
                            "refitting the selected model.")
                model.restore_full_sumstats()
                model.fit(**{k: v for k, v in fit_kwargs.items()
                             if k != 'pathwise'})

    return model, fit_time


def _device_budget_bytes(args, device):
    """The device memory the packed LD may take (65% of the budget, the rest
    for the state and workspace); None (no streaming) on the CPU without
    ``--device-memory-gb``."""
    if args.device_memory_gb is not None:
        return 0.65 * args.device_memory_gb * 1e9
    if device.type != 'cuda':
        return None
    import torch
    return 0.65 * torch.cuda.mem_get_info(device)[1]


def _plan_streaming(args, loader, device):
    """Chromosome groups when the packed LD exceeds the device budget; None
    for the (default) single genome-wide fit."""
    budget = _device_budget_bytes(args, device)
    if budget is None or loader.ld_snp_tables is None:
        return None
    per_chrom = loader.estimate_packed_bytes()
    total = sum(per_chrom.values())
    if total <= budget:
        return None
    groups = loader.plan_chromosome_groups(budget)
    logger.warning(
        "> Packed LD (~%.2f GB) exceeds the device budget (%.2f GB); "
        "streaming the fit over %d chromosome groups (reference "
        "per-chromosome semantics).", total / 1e9, budget / 1e9, len(groups))
    return groups


def _write_prof(out_prefix, data_time, fit_time, total_iters, t_start,
                groups=None):
    from ..utils.table import Table
    prof = {'DataPrep_Time': round(data_time, 3),
            'Fit_time': round(fit_time, 3),
            'Total_Iterations': total_iters,
            'Total_WallClockTime': round(time.time() - t_start, 3)}
    if groups is not None:
        prof['Streamed_Groups'] = len(groups)
    else:
        try:
            import psutil
            prof['Peak_Memory_MB'] = round(
                psutil.Process().memory_info().rss / 1024 ** 2, 2)
        except ImportError:
            pass
    Table({k: [v] for k, v in prof.items()}).write(out_prefix + '.prof')


def _mkdir_for(out_prefix):
    out_dir = osp.dirname(out_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)


def run(argv=None):
    """viprs_fit on the port: parse ``argv``, read, fit and write the
    outputs. Returns a record of the run: the seconds of each stage
    (``seconds``: the loader's 'tables', 'sumstats', 'harmonize',
    'ld_read', 'pack', 'cache' and 'upload' where they ran, then 'fit' and
    'write'), the iterations, each fit's last message, the chromosome
    groups of a streamed fit,
    the stores whose LD data was read, the output prefix and the loader
    (which holds the dataset of a fit that was not streamed)."""
    args = check_args(build_parser().parse_args(argv))
    mesh = resolve_mesh_arg(args.mesh)
    device = resolve_device(args.device)
    if mesh is not None and mesh.rank != 0:
        return _run(args, device, mesh)

    from ..utils.system import setup_logger
    targets = setup_logger(modules=['viprs_fit', 'viprs_tpu_torch'],
                           log_file=args.output_file + '.log',
                           log_level=args.log_level)
    added = list(targets[0].handlers[-2:])
    try:
        return _run(args, device, mesh)
    finally:
        # a run's log handlers end with it (a process may run several)
        for h in added:
            for lg in targets:
                lg.removeHandler(h)
            h.close()


def resolve_mesh_arg(spec):
    """The mesh of ``--mesh``: ``'off'`` is None; otherwise the process
    joins the group of a torchrun launch first (``init_distributed``, a
    no-op in one process) and the spec resolves over its processes."""
    if spec == 'off':
        return None
    from ..parallel import init_distributed
    from ..parallel.mesh import resolve_mesh
    init_distributed()
    return resolve_mesh(spec)


def _run(args, device, mesh=None):
    logger.info("> Parsed arguments: %s", vars(args))
    # under a mesh the data stays on the host and each rank's models copy
    # their shard of the LD to the card; only rank 0 writes
    import torch
    host = device if mesh is None else torch.device('cpu')
    writer = mesh is None or mesh.rank == 0
    if args.seed is not None:
        np.random.seed(args.seed)

    t_start = time.time()
    logger.info("> Loading and harmonizing data...")
    loader, validation_gdl, validation_ss = init_data(args, device)
    groups = _plan_streaming(args, loader, device)
    if groups is None:
        datasets = [(None, loader.to_summary_dataset(device=host))]
    else:
        datasets = loader.iter_group_datasets(groups, device=host)

    from ..utils.table import Table
    fit_tables, hyp_tables, val_tables = [], [], []
    halo_rows = None
    fit_time = data_time = 0.0
    total_iters = 0
    messages = []
    t_data = t_start
    for gi, (group, dataset) in enumerate(datasets):
        data_time += time.time() - t_data
        if group is not None:
            logger.info("> [group %d/%d] chromosomes %s (%d variants)",
                        gi + 1, len(groups), group, dataset.m)
        logger.info("> Preparing model (%s / %s)...", args.model,
                    args.hyp_search)
        model = prepare_model(args, dataset, device, mesh)
        model, ft = fit_model(args, model, validation_gdl, validation_ss)
        halo_rows = getattr(model._ld, 'halo_rows', None)
        fit_time += ft
        total_iters += int(getattr(model.optim_result, 'nit', 0) or 0)
        # a selected grid point's refit reports its own status
        rows = getattr(model, 'optim_results', None)
        messages.append(rows[0].message if rows and len(rows) == 1
                        else model.optim_result.message)
        fit_tables.append(model.to_table())
        ht = model.to_theta_table()
        vt = (model.to_validation_table()
              if getattr(model, 'validation_result', None) else None)
        if group is not None:
            label = ','.join(str(c) for c in group)
            ht.insert(0, 'Chromosomes', label)
            if vt is not None:
                vt.insert(0, 'Chromosomes', label)
        hyp_tables.append(ht)
        if vt is not None:
            val_tables.append(vt)
        del model, dataset
        t_data = time.time()

    t0 = time.time()
    out_prefix = args.output_file
    streamed = '' if groups is None else \
        f" (streamed over {len(groups)} chromosome groups)"
    if writer:
        _mkdir_for(out_prefix)
        Table.concat(fit_tables).write(out_prefix + '.fit.gz')
        Table.concat(hyp_tables).write(out_prefix + '.hyp')
        if val_tables:
            Table.concat(val_tables).write(out_prefix + '.validation')
        if args.profiler:
            _write_prof(out_prefix, data_time, fit_time, total_iters,
                        t_start, groups)
        logger.info("> Done%s. Outputs written with prefix %s", streamed,
                    out_prefix)
        print(f"viprs_fit_torch finished in {time.time() - t_start:.2f}s"
              f"{streamed}; outputs: {out_prefix}.fit.gz")
    t_write = time.time() - t0
    seconds = dict(loader.timings)
    seconds.update(fit=fit_time, write=t_write,
                   total=time.time() - t_start)
    return {'seconds': seconds, 'nit': total_iters, 'messages': messages,
            'groups': groups,
            'ld_data_reads': loader.ld_data_reads, 'device': str(device),
            'output': out_prefix if writer else None, 'loader': loader,
            'mesh': None if mesh is None else dict(mesh.shape),
            'halo_rows': halo_rows}


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
