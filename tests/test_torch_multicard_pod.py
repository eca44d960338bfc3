"""``test_torch_multicard``'s tests on a ('pod', 'data', 'model') =
(2, 1, 2) mesh: the same checks against the JAX package, in a 4-rank
``gloo`` world of this module's own."""

from test_torch_multicard import (  # noqa: F401  (collected here too)
    mesh, pytest_generate_tests, runs,
    test_elastic_restore_places_each_leaf,
    test_prefill_matches_unsharded_port,
    test_train_step_metrics_match_reference,
    test_train_step_params_match_reference,
    test_train_step_state_matches_reference_and_stays_placed)

MESH = "pod2_data1_model2"
