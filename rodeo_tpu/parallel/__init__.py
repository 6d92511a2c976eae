r"""
Multi-device scaling utilities: device-mesh construction and sharded
vmapped MCMC chains / parameter sweeps (pure data parallelism over NVLink —
the natural scale-out axes for this library, see SURVEY.md §5).
"""
from rodeo_tpu.parallel.mesh import (
    make_mesh, batch_sharding, replicated_sharding)
from rodeo_tpu.parallel.chains import (
    run_chains, make_run_chains, run_chains_fused, make_mala_runner,
    run_chains_mala_fused, run_chains_mala_magi, make_hmc_runner,
    run_chains_hmc_fused, run_chains_hmc_magi, adapt_step_size,
    adapt_warmup,
    magi_sig2_quadform, run_chains_magi_gibbs, sharded_loglik)
from rodeo_tpu.parallel.diagnostics import ess, rhat
from rodeo_tpu.parallel.nuts import (
    make_nuts_runner, run_chains_nuts_fused, run_chains_nuts_magi)
from rodeo_tpu.parallel.ptime_sharded import (
    sharded_parallel_filter, sharded_parallel_filter_tv,
    sharded_parallel_smooth_mv,
    sharded_solve_mv_iterated)
from rodeo_tpu.parallel.fused import (
    sharded_solve_mv_fused_batch, sharded_fenrir_fused_batch,
    sharded_dalton_fused_batch, sharded_daltonng_fused_batch,
    sharded_basic_fused_batch, sharded_solve_sim_fused_batch,
    sharded_fenrir_fused_batch_grad, sharded_dalton_fused_batch_grad,
    sharded_basic_fused_batch_grad, sharded_magi_fused_batch,
    sharded_magi_fused_batch_grad, run_chains_fused_sharded)
from rodeo_tpu.parallel.large_state import sharded_solve_mv_stationary
